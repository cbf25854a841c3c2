"""Train CLI of the PyTorch port (the reference's `main.py`).

    python -m ruart_tpu_torch.cli.main --conf_file conf_stvqa [--log_file name]

The conf file uses the reference format; `datadir` is the conf file's
directory, `FEATURE_FOLDER` defaults to ``<datadir>/source/data/<source_dir>/``
(`BaseTrainer.py:22-23`). Training runs on the CUDA card; the environment
variable ``RUART_PLATFORM=cpu`` (the switch the JAX package's CLIs honour)
is the one way to run it on the CPU.
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
    thresholds (``utils.gctune``; ``NO_GC_TUNE`` opts out). The JAX
    package's other switches (compile cache, platform) have no
    counterpart: the device comes from :func:`platform_device`."""
    from ruart_tpu_torch.utils.gctune import tune_gc

    tune_gc(cfg.opt)


def main(argv=None):
    parser = argparse.ArgumentParser(description="ruart-tpu PyTorch port")
    parser.add_argument("--command", default="train", help="Command: train")
    parser.add_argument("--conf_file", default="conf_stvqa", help="Path to conf file.")
    parser.add_argument("--log_file", default="", help="Path to log file.")
    args = parser.parse_args(argv)

    setup_logging(args.log_file)
    cfg = build_config(args.conf_file)
    apply_runtime_flags(cfg)

    from ruart_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=platform_device())
    print("Select command: " + args.command)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
