"""Train CLI of the PyTorch port (the reference's `main.py`).

    python -m ruart_tpu_torch.cli.main --conf_file conf_stvqa [--log_file name]

The conf file uses the reference format; `datadir` is the conf file's
directory, `FEATURE_FOLDER` defaults to ``<datadir>/source/data/<source_dir>/``
(`BaseTrainer.py:22-23`). Training runs on the CUDA card; the environment
variable ``RUART_PLATFORM=cpu`` (the switch the JAX package's CLIs honour)
is the one way to run it on the CPU.

On a host with several visible cards (and no ``no_mesh`` or
``coordinator_address`` in the conf) the command starts one rank per card
(``parallel.launch.spawn``), each with ``coordinator_address``,
``num_processes``, ``process_id`` and ``local_device_ids`` set, and the
ranks train on the (dp, tp) mesh as the JAX CLI does on a multi-device
host. Across hosts, run the command once per card with those four keys
in each rank's conf (``coordinator_address`` naming rank 0's host).
"""

from __future__ import annotations

import argparse
import logging
import os


def build_config(conf_file: str, overrides=None):
    from ruart_tpu_torch.core.config import Config

    cfg = Config.from_file(conf_file)
    cfg.opt["confFile"] = conf_file
    cfg.opt["datadir"] = os.path.dirname(conf_file)
    cfg.opt.setdefault(
        "FEATURE_FOLDER",
        os.path.join(
            cfg.opt["datadir"], "./source/data/", str(cfg.opt.get("source_dir", "")), ""
        ),
    )
    for k, v in (overrides or {}).items():
        cfg.opt[k] = v
    return cfg


def setup_logging(log_file: str = ""):
    logging.basicConfig(
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        level=logging.INFO,
        datefmt="%m/%d/%Y %I:%M:%S",
    )
    if log_file:
        os.makedirs("myLog", exist_ok=True)
        handler = logging.FileHandler(os.path.join("myLog", log_file + ".txt"))
        logging.getLogger().addHandler(handler)


def platform_device():
    """``None`` (the CUDA card, which must exist) unless RUART_PLATFORM
    names another torch device type, e.g. ``cpu``."""
    return os.environ.get("RUART_PLATFORM") or None


def apply_runtime_flags(cfg):
    """Conf-gated process switches of the CLIs: the host pipeline's GC
    thresholds (``utils.gctune``; ``NO_GC_TUNE`` opts out), and
    ``debug_nans``, the counterpart of ``jax_debug_nans``: autograd's
    anomaly detection (a backward that makes NaN raises, naming the
    forward op), and the trainer checks every train and eval step's
    inputs, scores and loss, raising FloatingPointError at the first NaN
    or Inf (``train.train_step``). The compile cache and platform switches
    have no counterpart: the device comes from :func:`platform_device`."""
    import torch

    from ruart_tpu_torch.utils.gctune import tune_gc

    tune_gc(cfg.opt)
    if "debug_nans" in cfg.opt:
        torch.autograd.set_detect_anomaly(True)


def cards_to_spawn(cfg) -> int:
    """How many ranks this command starts itself: one per visible card on
    a host with several, unless the conf has ``no_mesh``, already names a
    world (``coordinator_address``), or the command runs off the card."""
    import torch

    if (platform_device() is not None or "no_mesh" in cfg.opt
            or "coordinator_address" in cfg.opt
            or not torch.cuda.is_available()):
        return 0
    n = torch.cuda.device_count()
    return n if n > 1 else 0


def rank_overrides(rank: int, world: int, address: str) -> dict:
    """The conf keys of one rank of a one-host world, one card each."""
    return {"coordinator_address": address, "num_processes": world,
            "process_id": rank, "local_device_ids": str(rank)}


def rank_main(rank: int, world: int, address: str, argv, command="train"):
    """One rank of the world :func:`main` (``command`` 'train') or
    ``cli.main_test`` ('predict') starts (``parallel.launch``)."""
    overrides = rank_overrides(rank, world, address)
    if command == "train":
        main(argv, overrides=overrides)
    else:
        from ruart_tpu_torch.cli.main_test import main as predict

        predict(argv, overrides=overrides)


def spawn_ranks(n: int, argv, command: str = "train") -> None:
    from ruart_tpu_torch.parallel.launch import spawn

    logging.getLogger(__name__).info("starting %d ranks, one per card", n)
    spawn("ruart_tpu_torch.cli.main:rank_main", n, args=(list(argv), command))


def main(argv=None, overrides=None):
    """Train from the conf file; ``overrides`` are conf keys set on top
    (a rank's world keys). Returns the trainer, or None where the command
    started one rank per card."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description="ruart-tpu PyTorch port")
    parser.add_argument("--command", default="train", help="Command: train")
    parser.add_argument("--conf_file", default="conf_stvqa", help="Path to conf file.")
    parser.add_argument("--log_file", default="", help="Path to log file.")
    args = parser.parse_args(argv)

    setup_logging(args.log_file)
    cfg = build_config(args.conf_file, overrides)
    n = cards_to_spawn(cfg)
    if n:
        spawn_ranks(n, argv)
        return None
    apply_runtime_flags(cfg)

    from ruart_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=platform_device())
    print("Select command: " + args.command)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
