"""Synthetic data sources (numpy only): speech and token streams.

TIMIT is licensed and not redistributable, so the speech stream is a
TIMIT-shaped generator: 40-dim fbank-like features at 100 frames/s (25 ms
window, 10 ms shift), 1920 senone classes (the Kaldi tri-phone state
inventory), with phoneme-segment temporal structure so the RSNN's
recurrence has something to learn.  Real TIMIT features drop into the same
interface.

The LM stream is a sparse-transition Markov chain over the vocabulary —
learnable structure for the token LMs.  The port keeps its own copy of
the reference's generators; a batch is the reference's, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpeechDataConfig:
    input_dim: int = 40
    num_classes: int = 1920
    num_phones: int = 48  # latent phone inventory; classes = phone-state bins
    frames: int = 100  # 1 s utterances
    min_seg: int = 3
    max_seg: int = 18
    noise: float = 0.35
    seed: int = 0


class TimitLikeStream:
    """Deterministic, seekable synthetic speech stream: ``batch(n, step)``
    depends only on the config and ``step``."""

    def __init__(self, cfg: SpeechDataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # per-phone prototype trajectories (stationary mean + delta)
        self.proto = root.normal(
            size=(cfg.num_phones, cfg.input_dim)).astype(np.float32)
        self.delta = 0.15 * root.normal(
            size=(cfg.num_phones, cfg.input_dim)).astype(np.float32)
        # phone -> contiguous senone-state block
        states_per_phone = cfg.num_classes // cfg.num_phones
        self.state_base = np.arange(cfg.num_phones) * states_per_phone
        self.states_per_phone = states_per_phone

    def batch(self, batch_size: int, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        feats = np.empty((batch_size, cfg.frames, cfg.input_dim), np.float32)
        labels = np.empty((batch_size, cfg.frames), np.int32)
        for b in range(batch_size):
            t = 0
            while t < cfg.frames:
                ph = rng.integers(cfg.num_phones)
                seg = int(rng.integers(cfg.min_seg, cfg.max_seg + 1))
                seg = min(seg, cfg.frames - t)
                pos = np.linspace(0.0, 1.0, seg, dtype=np.float32)[:, None]
                feats[b, t:t + seg] = self.proto[ph] + pos * self.delta[ph]
                # senone = phone state progressing through the segment
                state = np.minimum(
                    (pos[:, 0] * self.states_per_phone).astype(np.int32),
                    self.states_per_phone - 1)
                labels[b, t:t + seg] = self.state_base[ph] + state
                t += seg
        feats += cfg.noise * rng.normal(size=feats.shape).astype(np.float32)
        return {"features": feats, "labels": labels}


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int = 503
    branching: int = 8  # sparse next-token choices per token
    seed: int = 0


class MarkovLMStream:
    """Sparse-transition Markov chain token stream (seekable):
    ``batch(n, seq_len, step)`` depends only on the config and ``step``."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.next_tokens = rng.integers(
            0, cfg.vocab_size,
            size=(cfg.vocab_size, cfg.branching)).astype(np.int32)

    def batch(self, batch_size: int, seq_len: int, step: int) -> dict:
        rng = np.random.default_rng((self.cfg.seed, step))
        toks = np.empty((batch_size, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.cfg.vocab_size, batch_size)
        choices = rng.integers(0, self.cfg.branching,
                               size=(batch_size, seq_len))
        for t in range(1, seq_len):
            toks[:, t] = self.next_tokens[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}
