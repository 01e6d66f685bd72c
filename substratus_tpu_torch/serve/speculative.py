"""Speculative decoding, the standalone per-request API (port of
substratus_tpu/serve/speculative.py): a draft model proposes, the target
verifies.

A decode step streams every weight for one token. Speculation amortizes
that stream: the draft greedily proposes k tokens (k cheap steps), then
one target forward scores all k+1 positions; the longest prefix where the
target's greedy choice equals the proposal is accepted, plus the target's
correction at the first mismatch. Greedy acceptance makes the output
token for token that of plain greedy decoding of the target.

Full acceptance emits the k proposals and no bonus token: the draft never
wrote the last proposal's entries, so that token seeds the next round and
both caches stay free of holes. Rejected proposals leave entries past the
accepted point; the causal mask never reads past a query's position and
the next round rewrites exactly those positions.

This module is the numerical reference of the acceptance rule. Serving
runs the batched form inside the engine (serve/engine.py, EngineConfig
spec_k with a draft model or prompt lookup), with the same rule.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from substratus_tpu_torch.models import llama
from substratus_tpu_torch.ops.decode_attention import pack_fragment


def _prefilled_cache(params: llama.Llama, cfg: llama.LlamaConfig, prompt: torch.Tensor, cache_len: int):
    """(last-position logits, a one-row dense cache holding the prompt)."""
    logits, kv = llama.forward(params, prompt, cfg)
    cache = llama.init_cache(cfg, 1, cache_len, device=prompt.device)
    for key, value in pack_fragment(cache, kv).items():
        cache[key][:, :, :, : value.shape[3]].copy_(value)
    return logits[0, -1], cache


def _propose(params, cache, token: int, pos: int, cfg, k: int, device) -> List[int]:
    """k greedy draft tokens from `token` at position `pos` (the draft's
    cache written at pos..pos+k-1)."""
    out, tok = [], torch.tensor([[token]], device=device)
    for i in range(k):
        logits, _ = llama.forward(params, tok, cfg, positions=torch.tensor([[pos + i]], device=device), cache=cache)
        tok = logits[:, 0].argmax(-1, keepdim=True)
        out.append(int(tok))
    return out


def _verify(params, cache, tokens: List[int], pos0: int, cfg, device) -> List[int]:
    """One target forward over [last, d1..dk] at positions pos0..; the
    greedy choice at every position."""
    positions = pos0 + torch.arange(len(tokens), device=device)[None, :]
    logits, _ = llama.forward(params, torch.tensor([tokens], device=device), cfg, positions=positions, cache=cache)
    return logits[0].argmax(-1).tolist()


@torch.inference_mode()
def speculative_generate(
    target_params: llama.Llama,
    target_cfg: llama.LlamaConfig,
    draft_params: llama.Llama,
    draft_cfg: llama.LlamaConfig,
    prompt_tokens: List[int],
    max_tokens: int = 64,
    k: int = 4,
    eos_token_id: int = -1,
    cache_len: int = 1024,
) -> Tuple[List[int], Dict[str, float]]:
    """Greedy generation from the target, accelerated by the draft, on the
    device the target's weights live on. Returns (tokens, stats): stats
    counts target forwards against tokens produced."""
    device = target_params.device
    prompt = torch.tensor([prompt_tokens], device=device)
    t_logits, t_cache = _prefilled_cache(target_params, target_cfg, prompt, cache_len)
    _, d_cache = _prefilled_cache(draft_params, draft_cfg, prompt, cache_len)

    out = [int(t_logits.argmax())]
    pos = len(prompt_tokens)  # the next position both models write
    target_passes = 1
    while len(out) < max_tokens and out[-1] != eos_token_id:
        # A verify writes pos..pos+step_k; the last row is cache_len - 1.
        step_k = min(k, max_tokens - len(out), cache_len - 1 - pos)
        if step_k < 1:
            break
        proposal = _propose(draft_params, d_cache, out[-1], pos, draft_cfg, step_k, device)
        choices = _verify(target_params, t_cache, [out[-1]] + proposal, pos, target_cfg, device)
        target_passes += 1
        accepted = 0
        while accepted < step_k and proposal[accepted] == choices[accepted]:
            accepted += 1
        if accepted == step_k:
            new_tokens = proposal  # no bonus token: the last proposal seeds the next round
            pos += accepted
        else:
            new_tokens = proposal[:accepted] + [choices[accepted]]
            pos += accepted + 1
        for tok in new_tokens:
            out.append(tok)
            if tok == eos_token_id or len(out) >= max_tokens:
                break

    stats = {"tokens": len(out), "target_passes": target_passes,
             "tokens_per_target_pass": round(len(out) / max(1, target_passes), 2)}
    return out, stats
