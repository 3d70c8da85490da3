"""Serving engine: slot-based continuous batching over the decode step.

Port of ``repro.serve.engine``, with the same slot semantics.  A fixed
pool of B slots each owns a stripe of the KV/SSM caches.  A request
occupies a free slot (its prompt is fed token by token through the same
decode step: prefill-by-decode), generates until EOS, its budget or
``max_seq``, then frees the slot for the next request; slots at different
positions advance together in one batched decode step.

``submit`` and the step return new ``ServerState``s, except that the
caches are updated in place (they are the one large part of the state).
Sampling at ``temperature > 0`` draws from an explicit
``torch.Generator``; greedy sampling is ``argmax``, whose first-index tie
rule is ``jnp.argmax``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

__all__ = ["ServeConfig", "ServerState", "init_server", "make_serve_step",
           "submit"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 8
    max_seq: int = 256
    temperature: float = 0.0        # 0 => greedy
    eos_token: int = 1


@dataclasses.dataclass
class ServerState:
    caches: dict
    position: torch.Tensor       # i32[B] next index to write
    active: torch.Tensor         # bool[B] slot generating
    in_prompt: torch.Tensor      # i32[B] remaining prompt tokens to consume
    prompts: torch.Tensor        # i32[B, Pmax(,CB)] queued prompt tokens
    last_token: torch.Tensor     # i32[B(,CB)] token to feed next
    generated: torch.Tensor      # i32[B, Gmax(,CB)] output buffer
    n_generated: torch.Tensor    # i32[B]
    budget: torch.Tensor         # i32[B] max new tokens per request


def _tok_shape(cfg: ModelConfig, *lead):
    return (*lead, cfg.num_codebooks) if cfg.num_codebooks else lead


def init_server(cfg: ModelConfig, scfg: ServeConfig, *, prompt_max: int = 64,
                gen_max: int = 64, device=None, constrain=None
                ) -> ServerState:
    """Empty slots.  ``constrain`` goes to ``M.init_cache``: with its
    ``cache_specs`` the caches are this rank's blocks (the slots' other
    state stays whole on every rank)."""
    dev = resolve_device(device)
    b = scfg.slots
    i32 = dict(dtype=torch.int32, device=dev)
    return ServerState(
        caches=M.init_cache(cfg, b, scfg.max_seq, device=dev,
                            constrain=constrain),
        position=torch.zeros((b,), **i32),
        active=torch.zeros((b,), dtype=torch.bool, device=dev),
        in_prompt=torch.zeros((b,), **i32),
        prompts=torch.zeros(_tok_shape(cfg, b, prompt_max), **i32),
        last_token=torch.zeros(_tok_shape(cfg, b), **i32),
        generated=torch.zeros(_tok_shape(cfg, b, gen_max), **i32),
        n_generated=torch.zeros((b,), **i32),
        budget=torch.zeros((b,), **i32),
    )


def _set(t: torch.Tensor, index, value) -> torch.Tensor:
    out = t.clone()
    out[index] = value
    return out


def submit(state: ServerState, slot: int, prompt: np.ndarray,
           max_new: int) -> ServerState:
    """Host-side request admission into a free slot."""
    if bool(state.active[slot]):
        raise ValueError(f"slot {slot} busy")
    p = len(prompt)
    prompts = _set(state.prompts, (slot, slice(0, p)),
                   torch.as_tensor(np.asarray(prompt), dtype=torch.int32))
    return dataclasses.replace(
        state,
        prompts=prompts,
        position=_set(state.position, slot, 0),
        in_prompt=_set(state.in_prompt, slot, p),
        active=_set(state.active, slot, True),
        last_token=_set(state.last_token, slot, prompts[slot, 0]),
        n_generated=_set(state.n_generated, slot, 0),
        budget=_set(state.budget, slot, max_new),
    )


def _bcast(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def make_serve_step(cfg: ModelConfig, scfg: ServeConfig, params,
                    constrain=None):
    """One continuous-batching step over all slots:
    ``step(state, generator=None) -> (state, next_tok)``.  ``constrain``
    goes to ``M.decode_step`` (``params`` and the caches this rank's
    blocks); every rank holds every slot, gets the whole logits and
    samples alike, so its rows must not be split over batch axes."""
    if constrain is not None and constrain.batch_axes:
        raise ValueError(f"the slots are whole on every rank; a constrain "
                         f"splitting them over {constrain.batch_axes} "
                         f"needs each rank's rows")

    def sample(logits, generator):
        if scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / scfg.temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        draw = torch.multinomial(flat, 1, generator=generator)
        return draw.reshape(probs.shape[:-1]).to(torch.int32)

    def step(state: ServerState, generator: Optional[torch.Generator] = None):
        toks = state.last_token[:, None]               # [B,1(,CB)]
        logits, caches = M.decode_step(params, cfg, toks, state.caches,
                                       state.position, constrain=constrain)
        next_tok = sample(logits[:, 0], generator)     # [B(,CB)]

        b = state.position.shape[0]
        rows = torch.arange(b, device=next_tok.device)
        pos = state.position + 1
        in_prompt = torch.clamp(state.in_prompt - 1, min=0)
        still_prompt = in_prompt > 0
        # while consuming the prompt, the next input is the next prompt
        # token; afterwards it is the sampled one
        gather_idx = torch.clamp(pos, max=state.prompts.shape[1] - 1).long()
        prompt_next = state.prompts[rows, gather_idx]
        feed = torch.where(_bcast(still_prompt, prompt_next), prompt_next,
                           next_tok)

        emitting = state.active & ~still_prompt
        gslot = torch.clamp(state.n_generated,
                            max=state.generated.shape[1] - 1).long()
        gen = state.generated.clone()
        gen[rows, gslot] = torch.where(_bcast(emitting, next_tok), next_tok,
                                       state.generated[rows, gslot])
        n_gen = state.n_generated + emitting.to(torch.int32)

        eos = next_tok == scfg.eos_token
        if cfg.num_codebooks:
            eos = eos.all(-1)
        done = emitting & (eos | (n_gen >= state.budget)
                           | (pos >= scfg.max_seq - 1))
        active = state.active & ~done

        new = dataclasses.replace(
            state, caches=caches, position=pos, in_prompt=in_prompt,
            last_token=torch.where(_bcast(state.active, feed), feed,
                                   state.last_token),
            generated=gen, n_generated=n_gen, active=active)
        return new, next_tok

    return torch.no_grad()(step)
