"""§Perf hillclimb variants: named config transforms applied on top of the
baseline arch configs, so every optimization step is a reproducible
``--variant`` of a run.  The reference's ``launch/variants.py`` on the
port's ``ModelConfig``."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def seq_scan(cfg: ModelConfig) -> ModelConfig:
    """BASELINE recurrence: a sequential scan over time (paper-faithful
    port of a step-recurrent GPU kernel)."""
    if cfg.ssm is None:
        return cfg
    return dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, scan_impl="sequential"))


def chunked_scan(cfg: ModelConfig, chunk: int = 128) -> ModelConfig:
    if cfg.ssm is None:
        return cfg
    return dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, scan_impl="chunked",
                                     chunk=chunk))


def ragged_moe(cfg: ModelConfig) -> ModelConfig:
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, router_impl="ragged"))


def moe_group(cfg: ModelConfig, group: int) -> ModelConfig:
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, group_size=group))


def no_remat(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, remat="none")


VARIANTS = {
    "baseline_seqscan": seq_scan,
    "chunked": chunked_scan,
    "chunked64": lambda c: chunked_scan(c, 64),
    "chunked256": lambda c: chunked_scan(c, 256),
    "ragged_moe": ragged_moe,
    "moe_group2048": lambda c: moe_group(c, 2048),
    "moe_group128": lambda c: moe_group(c, 128),
    "no_remat": no_remat,
}


def apply(cfg: ModelConfig, variant: str | None) -> ModelConfig:
    if not variant:
        return cfg
    out = cfg
    for v in variant.split("+"):
        out = VARIANTS[v](out)
    return out
