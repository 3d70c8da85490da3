"""Shape-only stand-ins for every (arch x shape) dry-run cell
(``repro.launch.specs``): fake tensors, under a
``torch._subclasses.fake_tensor.FakeTensorMode``, whose shapes and
dtypes are those of JAX's ``ShapeDtypeStruct``s.

Nothing is allocated: the dry-run (``launch.dryrun``) traces its
programs on these.  Shapes follow the assignment:
  train_4k     train_step  tokens/targets [B=256, S=4096]
  prefill_32k  prefill     tokens [B=32, S=32768]
  decode_32k   serve_step  one token, KV cache of 32768, B=128
  long_500k    serve_step  one token, cache of 524288, B=1 (sub-quadratic)

For llava the text tokens are S - vision_tokens and ``vision_embeds``
supplies the patch-embedding stub, so total context length equals the
assigned S.  Musicgen tokens carry the trailing codebook dim.

Each function takes the ``FakeTensorMode`` its tensors belong to
(``mode``; a new one when None) and is called outside it: tensors of two
modes do not mix.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs as CFG
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

__all__ = ["train_inputs", "prefill_inputs", "decode_inputs",
           "train_state_shapes", "params_shapes"]


def _tok_shape(cfg: ModelConfig, b: int, s: int):
    return (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="cpu")


def _batch(cfg: ModelConfig, shape: CFG.ShapeSpec, keys) -> dict:
    b, s = shape.global_batch, shape.seq_len
    s_text = s - (cfg.vision_tokens or 0)
    out = {k: _empty(_tok_shape(cfg, b, s_text), torch.int32)
           for k in keys}
    if cfg.vision_tokens:
        out["vision_embeds"] = _empty((b, cfg.vision_tokens, cfg.d_model),
                                      torch.float32)
    return out


def train_inputs(cfg: ModelConfig, shape: CFG.ShapeSpec,
                 mode: Optional[FakeTensorMode] = None) -> dict:
    with mode or FakeTensorMode():
        return _batch(cfg, shape, ("tokens", "targets"))


def prefill_inputs(cfg: ModelConfig, shape: CFG.ShapeSpec,
                   mode: Optional[FakeTensorMode] = None) -> dict:
    with mode or FakeTensorMode():
        return _batch(cfg, shape, ("tokens",))


def decode_inputs(cfg: ModelConfig, shape: CFG.ShapeSpec,
                  mode: Optional[FakeTensorMode] = None) -> dict:
    b, s = shape.global_batch, shape.seq_len
    with mode or FakeTensorMode():
        return {
            "tokens_new": _empty(_tok_shape(cfg, b, 1), torch.int32),
            "caches": M.init_cache(cfg, b, s, device="cpu"),
            "position": _empty((b,), torch.int32),
        }


def params_shapes(cfg: ModelConfig,
                  mode: Optional[FakeTensorMode] = None) -> dict:
    with mode or FakeTensorMode():
        return M.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")


def train_state_shapes(cfg: ModelConfig, tcfg,
                       mode: Optional[FakeTensorMode] = None):
    from repro_torch.train import init_train_state
    with mode or FakeTensorMode():
        return init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
