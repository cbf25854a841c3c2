"""Test-inference CLI of the PyTorch port (the reference's `main_test.py`):
loads the checkpoint named by ``MODEL_PATH`` and writes ``submission.json``
next to it. Runs on the CUDA card unless ``RUART_PLATFORM=cpu``; on a host
with several cards, one rank per card (as ``cli.main``), rank 0 writing.

    python -m ruart_tpu_torch.cli.main_test --conf_file conf_with_RESUME_and_MODEL_PATH
"""

from __future__ import annotations

import argparse

from ruart_tpu_torch.cli.main import (
    apply_runtime_flags,
    build_config,
    cards_to_spawn,
    platform_device,
    setup_logging,
    spawn_ranks,
)


def main(argv=None, overrides=None):
    """Predict from the conf file; ``overrides`` are conf keys set on top
    (a rank's world keys). On a host with several cards it starts one rank
    per card, as ``cli.main`` does, and returns None; else the trainer."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description="ruart-tpu PyTorch port inference")
    parser.add_argument("--command", default="predict", help="Command: predict")
    parser.add_argument("--conf_file", default="conf", help="Path to conf file.")
    parser.add_argument("--log_file", default="", help="Path to log file.")
    args = parser.parse_args(argv)

    setup_logging(args.log_file)
    cfg = build_config(args.conf_file, overrides)
    n = cards_to_spawn(cfg)
    if n:
        spawn_ranks(n, argv, command="predict")
        return None
    apply_runtime_flags(cfg)

    from ruart_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=platform_device())
    print("Select command: " + args.command)
    trainer.predict_for_test()
    return trainer


if __name__ == "__main__":
    main()
