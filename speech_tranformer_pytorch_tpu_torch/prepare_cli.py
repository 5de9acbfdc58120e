"""Data preparation CLI (counterpart of the JAX package's ``prepare_cli.py``).

  python -m speech_tranformer_pytorch_tpu_torch.prepare_cli aishell \
      --corpus /data/aishell --out exp/data
  python -m speech_tranformer_pytorch_tpu_torch.prepare_cli synthetic \
      --out exp/synth --num-train 32 [--device cpu]

It writes files only; ``--device`` is checked as the other CLIs check it
(``cuda`` by default, which raises when there is no card).
"""

from __future__ import annotations

import argparse

from .device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device the port runs on (default: cuda)")

    a = sub.add_parser("aishell", help="AISHELL-1 manifests + char vocab",
                       parents=[device])
    a.add_argument("--corpus", required=True,
                   help="extracted corpus root (data_aishell/), or the "
                        "download destination with --download")
    a.add_argument("--out", required=True)
    a.add_argument("--min-count", type=int, default=1)
    a.add_argument("--download", action="store_true",
                   help="fetch and untar the OpenSLR release into --corpus "
                        "first (nested per-speaker wav tarballs included)")
    a.add_argument("--url", default=None,
                   help="override the OpenSLR URL (e.g. a local mirror)")

    ls = sub.add_parser("librispeech", help="LibriSpeech manifests + BPE vocab",
                        parents=[device])
    ls.add_argument("--corpus", required=True,
                    help="corpus root containing LibriSpeech/<split>/ (or the "
                         "LibriSpeech/ dir itself); with --download, the "
                         "download destination")
    ls.add_argument("--out", required=True)
    ls.add_argument("--train-splits", default="train-clean-100",
                    help="comma-separated (960h = train-clean-100,"
                         "train-clean-360,train-other-500)")
    ls.add_argument("--dev-splits", default="dev-clean")
    ls.add_argument("--test-splits", default="test-clean")
    ls.add_argument("--bpe-vocab-size", type=int, default=5000)
    ls.add_argument("--download", action="store_true",
                    help="fetch and untar the OpenSLR 12 split tarballs into "
                         "--corpus first")
    ls.add_argument("--url-base", default=None,
                    help="override the OpenSLR URL base (e.g. a local mirror)")

    s = sub.add_parser("synthetic", help="synthetic tone corpus fixture",
                       parents=[device])
    s.add_argument("--out", required=True)
    s.add_argument("--num-train", type=int, default=32)
    s.add_argument("--num-dev", type=int, default=8)
    s.add_argument("--num-test", type=int, default=8)
    s.add_argument("--vocab-size", type=int, default=32)
    s.add_argument("--seed", type=int, default=0)

    b = sub.add_parser("bpe", help="train a BPE tokenizer from a manifest",
                       parents=[device])
    b.add_argument("--manifest", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--vocab-size", type=int, default=5000)

    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.cmd == "aishell":
        from .data.prepare import AISHELL_URL, download_aishell, prepare_aishell
        corpus = args.corpus
        if args.download:
            corpus = download_aishell(args.corpus, url=args.url or AISHELL_URL)
        paths = prepare_aishell(corpus, args.out, min_count=args.min_count)
    elif args.cmd == "librispeech":
        from .data.prepare import (LIBRISPEECH_URL_BASE, download_librispeech,
                                   prepare_librispeech)
        splits = lambda s: tuple(x for x in s.split(",") if x)
        corpus = args.corpus
        if args.download:
            corpus = download_librispeech(
                args.corpus, splits(args.train_splits) + splits(args.dev_splits)
                + splits(args.test_splits),
                url_base=args.url_base or LIBRISPEECH_URL_BASE)
        paths = prepare_librispeech(
            corpus, args.out, train_splits=splits(args.train_splits),
            dev_splits=splits(args.dev_splits), test_splits=splits(args.test_splits),
            bpe_vocab_size=args.bpe_vocab_size)
    elif args.cmd == "synthetic":
        from .data.prepare import prepare_synthetic
        paths = prepare_synthetic(
            args.out, num_train=args.num_train, num_dev=args.num_dev,
            num_test=args.num_test, vocab_size=args.vocab_size, seed=args.seed)
    else:
        from .data.prepare import read_manifest
        from .data.tokenizer import BpeTokenizer
        texts = [e["text"] for e in read_manifest(args.manifest)]
        BpeTokenizer.train(texts, args.vocab_size).save(args.out)
        paths = {"vocab": args.out}
    print(paths)


if __name__ == "__main__":
    main()
