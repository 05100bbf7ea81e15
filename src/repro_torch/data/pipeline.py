"""Deterministic, resumable, sharded data pipeline (the port's copy of the
JAX package's ``data/pipeline.py``: numpy only, the same batches bit for
bit).

Synthetic token streams (zipfian unigram + short-range structure so tiny
models have learnable signal) keyed by (seed, step, shard) — any worker can
reproduce any batch, which is what checkpoint-restart and elastic rescaling
need: the pipeline state IS the step counter.  Audio/vision cells get
matching stand-in frontends (frames / patch embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class PipelineConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    n_shards: int = 1       # data-parallel shards
    shard_id: int = 0


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish unigram draw + markov-ish smoothing for learnable structure."""
    ranks = rng.zipf(1.3, size=shape).astype(np.int64)
    toks = np.minimum(ranks - 1, vocab - 1)
    # inject determinism: every 4th token repeats its predecessor's bucket
    toks[..., 3::4] = (toks[..., 2::4] * 31 + 7) % vocab
    return toks.astype(np.int32)


def make_batch(cfg: ArchConfig, pc: PipelineConfig, step: int) -> Dict:
    """The batch for (step, shard) — pure function of (seed, step, shard)."""
    assert pc.global_batch % pc.n_shards == 0
    local_b = pc.global_batch // pc.n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([pc.seed, step, pc.shard_id]))
    s = pc.seq_len
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
                    (local_b, s, cfg.audio_in_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab,
                                       (local_b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        s_txt = s - cfg.n_img_tokens
        return {"tokens": _zipf_tokens(rng, (local_b, s_txt), cfg.vocab),
                "img_embeds": rng.standard_normal(
                    (local_b, cfg.n_img_tokens,
                     cfg.d_model)).astype(np.float32) * 0.02}
    return {"tokens": _zipf_tokens(rng, (local_b, s), cfg.vocab)}


class DataIterator:
    """Stateful wrapper with exact-resume semantics."""

    def __init__(self, cfg: ArchConfig, pc: PipelineConfig, start_step: int = 0):
        self.cfg, self.pc = cfg, pc
        self.step = start_step

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        b = make_batch(self.cfg, self.pc, self.step)
        self.step += 1
        return b

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.pc.seed}

    @classmethod
    def restore(cls, cfg: ArchConfig, pc: PipelineConfig,
                state: Dict) -> "DataIterator":
        assert state["seed"] == pc.seed, "seed mismatch on resume"
        return cls(cfg, pc, start_step=state["step"])
