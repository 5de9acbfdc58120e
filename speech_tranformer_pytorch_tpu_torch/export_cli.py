"""Export-for-serving CLI (counterpart of the JAX package's
``export_cli.py``): a trained run's checkpoint becomes one self-contained
``torch.export`` artifact of the whole batched recognizer (``serving.py``)
plus its parameters as a flat ``.npz``.

  python -m speech_tranformer_pytorch_tpu_torch.export_cli \
      --work-dir exp/run1 --out exp/run1/decoder.pt2 \
      --batch-size 32 --frames 1000 --beam 5 --max-len 100 [--device cpu]

Export on the device that will serve (CUDA unless ``--device`` says
otherwise; the CPU artifact is for tests). The serving side needs torch
and the port's kernel operators, not the model code:
``serving.load_exported(open(p, 'rb').read())(params_flat, feats, lens)``
with ``params_flat`` the ``.npz``'s arrays in key order (``p00000``, ...),
as float32 tensors on that device.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work-dir", required=True,
                    help="training work dir (checkpoints/ + config.json)")
    ap.add_argument("--out", required=True, help="artifact path (.pt2)")
    ap.add_argument("--params-out", default=None,
                    help="flat-params .npz path (default: <out>.params.npz)")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--max-len", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="device the artifact is exported for and served on "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from .config import config_from_dict
    from .recognize import load_recognizer
    from .serving import export_recognizer, flatten_params

    saved = os.path.join(args.work_dir, "config.json")
    if not os.path.exists(saved):
        raise FileNotFoundError(
            f"{saved} not found — export needs the run's saved config "
            "(train_cli writes it)")
    with open(saved) as f:
        cfg = config_from_dict(json.load(f))
    # The artifact takes full-precision weights; int8 decoding is a feature
    # of the live Recognizer, as in JAX.
    cfg = cfg.replace(decode=cfg.decode.replace(int8_weights=False))
    rec = load_recognizer(cfg, os.path.join(args.work_dir, "checkpoints"),
                          device=args.device)
    alpha = args.alpha if args.alpha is not None else cfg.decode.length_penalty
    # The Recognizer's weights (cast to the compute dtype), as float32.
    params = {n: (t.float() if t.is_floating_point() else t).cpu()
              for n, t in rec.model.state_dict().items()}

    data = export_recognizer(
        cfg, params, batch_size=args.batch_size, frames=args.frames,
        beam_size=args.beam, max_len=args.max_len, alpha=alpha, device=args.device)
    with open(args.out, "wb") as f:
        f.write(data)

    params_out = args.params_out or args.out + ".params.npz"
    flat = flatten_params(params)
    np.savez(params_out, **{f"p{i:05d}": x.numpy() for i, x in enumerate(flat)})
    print(json.dumps({"artifact": args.out, "bytes": len(data),
                      "params": params_out, "num_param_leaves": len(flat),
                      "batch_size": args.batch_size, "frames": args.frames,
                      "beam": args.beam, "max_len": args.max_len}))


if __name__ == "__main__":
    main()
