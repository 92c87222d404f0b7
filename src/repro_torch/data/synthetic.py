"""Deterministic, shard-aware, resumable synthetic token/data pipeline.

Provides the training-data substrate: each (step, shard) batch is a pure
function of (seed, step, shard_index) so (a) any rank can regenerate any
shard — no data server to fail; (b) elastic re-sharding after a node loss
is trivial (the new layout just indexes differently); (c) restart from a
checkpointed step is exact. This is the same determinism contract real
frameworks get from a checkpointed tf.data/grain iterator.

A copy of the reference's ``src/repro/data/synthetic.py`` (numpy only):
the same (seed, step, shard, num_shards) gives the same arrays bit for
bit in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # modality stubs (audio frames / vision patches) — see input_specs()
    frontend: Optional[str] = None        # None | 'audio' | 'vision'
    frontend_len: int = 0                 # frames/patches per example
    frontend_dim: int = 0


def _fold(seed: int, *ints: int) -> np.random.Generator:
    s = np.random.SeedSequence([seed, *[int(i) & 0x7FFFFFFF for i in ints]])
    return np.random.default_rng(s)


def batch_for_step(cfg: DataConfig, step: int, shard: int = 0,
                   num_shards: int = 1) -> dict:
    """Materialize one shard of the global batch for `step` (host numpy).

    Tokens follow a Zipfian-ish distribution with short-range repetition so
    the loss actually decreases during the integration tests.
    """
    assert cfg.global_batch % num_shards == 0
    b = cfg.global_batch // num_shards
    rng = _fold(cfg.seed, step, shard)
    # zipf-ish via exponentiated uniform; cheap and vectorized
    u = rng.random((b, cfg.seq_len + 1))
    toks = np.floor((cfg.vocab_size - 1) * u ** 3.0).astype(np.int32)
    # inject copy structure: with p=.3 repeat token from 8 positions back
    mask = rng.random((b, cfg.seq_len + 1)) < 0.3
    toks[:, 8:] = np.where(mask[:, 8:], toks[:, :-8], toks[:, 8:])
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "audio":
        out["frontend"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    elif cfg.frontend == "vision":
        out["frontend"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def batch_rows(batch: dict, index: int, count: int) -> dict:
    """Rows [index B/count, (index+1) B/count) of every array of a global
    batch: the block the batch position `index` of `count` holds, as the
    reference shards ``batch_for_step(cfg, step)`` over its batch axes
    (``batch_for_step(..., shard, num_shards)`` draws other tokens)."""
    n = next(iter(batch.values())).shape[0]
    if n % count:
        raise ValueError(f"a global batch of {n} over {count} positions")
    per = n // count
    return {k: v[index * per:(index + 1) * per] for k, v in batch.items()}


class ShardedDataset:
    """Iterator facade with exact resume (state = step counter only).
    With `block` = (index, count) each batch is that block of rows of the
    global batch (:func:`batch_rows`): a rank's rows on a mesh."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 start_step: int = 0, block=None):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.step = start_step
        self.block = block

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = batch_for_step(self.cfg, self.step, self.shard,
                               self.num_shards)
        if self.block is not None:
            batch = batch_rows(batch, *self.block)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])
