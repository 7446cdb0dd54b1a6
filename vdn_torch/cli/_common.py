"""Shared CLI plumbing for the training entry points (vdn/cli/_common.py)."""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def parse_with_master_config(parser: argparse.ArgumentParser,
                             argv: Optional[Sequence[str]], family: str):
    """Parse args with an optional ``--config`` master-config overlay.

    The master config (see vdn_torch/core/config.py) sets new argparse
    defaults, selects the ``enabled:`` datasets, and doubles as the
    ``--dataset-config`` (its datasets/dataset_common sections are
    factory-shaped).  Explicit CLI flags always win because the overlay
    only changes defaults.
    """
    from vdn_torch.core.config import (enabled_datasets, load_master_config,
                                 overlay_args)

    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre_args, _ = pre.parse_known_args(argv)
    if pre_args.config:
        cfg = load_master_config(pre_args.config)
        overlay_args(parser, cfg, family, argv)
        if cfg.get("datasets"):
            parser.set_defaults(dataset_config=pre_args.config)
            names = enabled_datasets(cfg)
            if names:
                parser.set_defaults(datasets=names)
    args = parser.parse_args(argv)
    if getattr(args, "datasets", None) is None:
        args.datasets = ["Sintel"]
    if getattr(args, "dataset_config", None) is None:
        parser.error("--dataset-config is required (directly or via a "
                     "--config master config with a datasets: section)")
    return args
