"""Export the recognizer for serving (counterpart of the JAX package's
``serving.py``).

The whole batched recognizer (encoder, the KV-cache beam or greedy loop,
the length penalty) is exported by ``torch.export`` as one program for
fixed (batch, frames, beam, max_len). The decode loop is the fixed-trip
one (``early_stop=False``: the same results), traced once as a
``while_loop`` of ``max_len`` steps with no device sync
(``decoding.beam.decode_loop``). The kernels on that path are
``torch.library`` operators (``kernels/custom_ops.py``), so the program
calls them as the live decode does. A serving process loads it without
the model code or the config system; it imports the operators alone:

    data = export_recognizer(cfg, params, batch_size=32, frames=1000,
                             beam_size=5, max_len=100)
    open("decoder.pt2", "wb").write(data)
    # serving side:
    fn = load_exported(open("decoder.pt2", "rb").read())
    tokens, lengths, scores = fn(params_flat, feats, frame_lens)

Params travel as a flat list of float32 tensors (``flatten_params``, the
``state_dict`` order), so the artifact holds no weights. Export on the
device that will serve: the program is for that device (CUDA unless the
caller asks for the CPU; the CPU artifact is for tests).
"""

from __future__ import annotations

import io
from typing import Callable, Dict, List, Tuple

import torch

from .kernels import custom_ops  # noqa: F401  (registers the st_port operators)


def flatten_params(params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The leaves of a port ``state_dict``, in ``state_dict`` order."""
    return list(params.values())


class _Decode(torch.nn.Module):
    """Encode + fixed-trip decode of ``model`` (beam search, or greedy
    decoding at ``beam_size == 1`` with JAX's K = 1 shapes and zero
    scores)."""

    def __init__(self, model, *, beam_size: int, max_len: int, alpha: float):
        super().__init__()
        self.model = model
        self.beam_size, self.max_len, self.alpha = beam_size, max_len, alpha

    def forward(self, feats: torch.Tensor, frame_lens: torch.Tensor):
        from .decoding import beam_search, greedy_search

        memory, mem_lens = self.model.encode(feats, frame_lens)
        if self.beam_size == 1:
            r = greedy_search(self.model, memory, mem_lens, max_len=self.max_len,
                              early_stop=False)
            scores = torch.zeros(r.lengths.shape, dtype=torch.float32,
                                 device=r.lengths.device)
            return r.tokens[:, None, :], r.lengths[:, None], scores[:, None]
        r = beam_search(self.model, memory, mem_lens, beam_size=self.beam_size,
                        max_len=self.max_len, alpha=self.alpha, early_stop=False)
        return r.tokens, r.lengths, r.scores


class _Program(torch.nn.Module):
    """``forward(params_flat, feats, frame_lens)``: ``_Decode`` as a
    ``functional_call`` on the leaves, cast to the model's compute dtype
    (the dtype the live ``Recognizer`` casts its weights to). ``_Decode``
    is kept out of the module tree, so the exported program holds no
    weights; the model's buffers that are not leaves (the positional
    tables) are this module's, so that the program holds them as its
    constants."""

    def __init__(self, decode: _Decode, names: List[str]):
        super().__init__()
        self._decode = (decode,)
        self.names = names
        self.buffer_names = [n for n, _ in decode.model.named_buffers() if n not in names]
        for i, n in enumerate(self.buffer_names):
            self.register_buffer(f"buffer{i}", decode.model.get_buffer(n), persistent=False)

    def forward(self, params_flat: List[torch.Tensor], feats: torch.Tensor,
                frame_lens: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        decode = self._decode[0]
        dt = decode.model.decoder.dtype
        leaves = {"model." + n: (x.to(dt) if x.is_floating_point() else x)
                  for n, x in zip(self.names, params_flat)}
        leaves.update({"model." + n: getattr(self, f"buffer{i}")
                       for i, n in enumerate(self.buffer_names)})
        return torch.func.functional_call(decode, leaves, (feats, frame_lens))


def export_recognizer(cfg, params: Dict[str, torch.Tensor], *, batch_size: int,
                      frames: int, beam_size: int = 5, max_len: int = 100,
                      alpha: float = 1.0, device=None) -> bytes:
    """Serialize the batched recognizer for fixed (batch, frames) shapes.

    ``params`` is a float32 ``state_dict`` of ``SpeechTransformer``.
    Returns ``torch.export.save`` bytes of a program whose call signature is
    ``(params_flat, feats [B,T,F] f32, frame_lens [B] i32) ->
    (tokens [B,K,max_len] i32, lengths [B,K] i32, scores [B,K] f32)``
    (greedy at ``beam_size == 1``, with K = 1 shapes and zero scores), on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    from .config import serving_only_fields
    from .device import resolve_device
    from .models import SpeechTransformer

    if cfg.model.encoder == "conformer":
        raise ValueError("model.encoder='conformer' cannot be exported: the Conformer is "
                         "served by the Recognizer's graph-replayed beam search only")
    only = serving_only_fields(cfg)
    if only:
        raise ValueError(f"{only} cannot be exported: they are served by the Recognizer's "
                         f"graph-replayed beam search only")
    if cfg.decode.ctc_weight > 0.0:
        raise ValueError("decode.ctc_weight > 0 cannot be exported: the exported "
                         "decode loop has no CTC prefix scorer")
    dev = resolve_device(device)
    model = SpeechTransformer(cfg.model).to(dev, getattr(torch, cfg.model.dtype)).eval()
    decode = _Decode(model, beam_size=beam_size, max_len=max_len, alpha=alpha)
    program = _Program(decode, list(params))
    args = ([x.detach().to(dev, torch.float32) for x in flatten_params(params)],
            torch.zeros((batch_size, frames, cfg.model.input_dim), device=dev),
            torch.full((batch_size,), frames, dtype=torch.int32, device=dev))
    with torch.no_grad():
        exported = torch.export.export(program, args)
    exported.example_inputs = None   # they hold the weights: the artifact does not
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_exported(data: bytes) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """Deserialize an exported recognizer; returns the callable
    ``fn(params_flat, feats, frame_lens)``. Needs the ``st_port`` operators
    (imported with this module) and nothing else of the package."""
    return torch.export.load(io.BytesIO(data)).module()
