"""Synthetic data pipeline of the port: deterministic, restartable — a copy
of the reference's numpy generator (src/repro/training/data.py), so a
(config, step) gives the reference's tokens element for element.

A stateless index→batch map (seeded hash): the pipeline position is the
step counter, so a restart needs only `step` (the checkpoint stores it).
Sequences follow a Zipf unigram distribution with a bigram structure, so
the LM loss falls."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_dist: int = 0        # >0 → long-range copy dependency at this offset
    copy_prob: float = 0.3


def _batch_rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synth_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """[B, S+1] int64 token stream with learnable structure: bigram
    transitions and (optionally) long-range copies t[i] = t[i - copy_dist],
    announced by a 0 marker."""
    rng = _batch_rng(cfg.seed, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # zipf unigrams clipped into the vocab
    base = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64) % V
    # bigram structure: with p=0.5 the next token is f(prev) = (prev*7+3)%V
    follow = (base * 7 + 3) % V
    coin = rng.random((B, S + 1)) < 0.5
    out = base.copy()
    out[:, 1:] = np.where(coin[:, 1:], follow[:, :-1], base[:, 1:])
    if cfg.copy_dist > 0 and S + 1 > cfg.copy_dist:
        d = cfg.copy_dist
        cp = rng.random((B, S + 1)) < cfg.copy_prob
        cp[:, :d + 1] = False
        bs, ps = np.nonzero(cp)
        out[bs, ps - 1] = 0              # marker announces the copy
        out[bs, ps] = out[bs, ps - d]    # t[i] = t[i - d]
    return out


def make_batch(model_cfg: ModelConfig, data_cfg: DataConfig, step: int,
               device=None) -> dict:
    """The step's batch on `device` (None → cuda), the reference's element
    for element: {"tokens", "labels"} [B, S] int64 (the stream's first S
    tokens and its next S); for audio {"frames" [B, S, frontend_dim]
    float32 (standard normals from the step's seed + 1 stream), "labels"
    (the first S tokens mod vocab)}; for a vlm {"tokens" [B, S - P],
    "patches" [B, P, frontend_dim] float32 (seed + 2 stream), "labels"
    [B, S] (zeros over the patch prefix, then the next tokens), "mask" [B,
    S] float32 (zero over the prefix)}."""
    dev = resolve_device(device)
    toks = synth_tokens(data_cfg, step)
    B, S = data_cfg.global_batch, data_cfg.seq_len
    t = lambda a: torch.from_numpy(a).to(dev)
    if model_cfg.family == "audio":
        rng = _batch_rng(data_cfg.seed + 1, step)
        frames = rng.standard_normal(
            (B, S, model_cfg.frontend_dim)).astype(np.float32)
        return {"frames": t(frames),
                "labels": t(toks[:, :-1] % model_cfg.vocab_size)}
    if model_cfg.family == "vlm":
        Pn = model_cfg.num_patches
        rng = _batch_rng(data_cfg.seed + 2, step)
        patches = rng.standard_normal(
            (B, Pn, model_cfg.frontend_dim)).astype(np.float32)
        labels = np.concatenate([np.zeros((B, Pn), np.int64),
                                 toks[:, 1:S - Pn + 1]], axis=1)
        mask = np.concatenate([np.zeros((B, Pn), np.float32),
                               np.ones((B, S - Pn), np.float32)], axis=1)
        return {"tokens": t(np.ascontiguousarray(toks[:, :S - Pn])),
                "patches": t(patches), "labels": t(labels), "mask": t(mask)}
    toks = t(toks)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(model_cfg: ModelConfig, data_cfg: DataConfig,
            start_step: int = 0, device=None) -> Iterator[tuple]:
    step = start_step
    while True:
        yield step, make_batch(model_cfg, data_cfg, step, device)
        step += 1
