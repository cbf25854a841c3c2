"""Online-serving CLI of the PyTorch port: JSON-lines requests on stdin ->
answers on stdout (port of ``ruart_tpu/cli/serve_main.py``).

    python -m ruart_tpu_torch.cli.serve_main --conf_file conf_serve \\
        [--max_wait_ms 10] [--warmup N]

The conf must name a checkpoint (``RESUME`` + ``MODEL_PATH``, the keys of
the predict CLI); ``INT8_BERT`` serves with the weight-only int8 encoder.
Each stdin line is one request object (schema in
``ruart_tpu_torch/serve.py``); each stdout line is ``{"answer", "score",
"idx"}`` in input order. Requests are micro-batched by
:class:`ruart_tpu_torch.serve.BatchingServer` (``--max_wait_ms`` bounds
the batching delay a lone request pays). Runs on the CUDA card unless
``RUART_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from ruart_tpu_torch.cli.main import (
    apply_runtime_flags,
    build_config,
    platform_device,
    setup_logging,
)

log = logging.getLogger(__name__)


def build_engine(cfg, bert_config=None):
    """Trainer-backed engine construction: conf -> preprocessed meta ->
    model + checkpoint -> InferenceEngine (int8 when INT8_BERT is set)."""
    from ruart_tpu_torch.serve import InferenceEngine
    from ruart_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, bert_config=bert_config, device=platform_device())
    trainer.get_save_folder(is_train=False)
    trainer.preproc.ensure_preprocessed()
    vocab, _char_vocab, embeddings = trainer.preproc.load_data()
    trainer.vocab = vocab
    trainer.setup_model(embeddings)
    if "RESUME" in cfg.opt and "MODEL_PATH" in cfg.opt:
        model_path = os.path.join(cfg.opt["datadir"], cfg.opt["MODEL_PATH"])
        # isfile, not exists: get_save_folder(is_train=False) pre-creates
        # the MODEL_PATH run-folder prefix, so a typo'd path may exist as
        # a directory — serving random weights must fail loudly either way
        if not os.path.isfile(model_path):
            raise FileNotFoundError(f"RESUME checkpoint not found: {model_path}")
        trainer.load_model(model_path, with_optimizer=False)
    else:
        log.warning("no RESUME/MODEL_PATH in conf: serving initial weights")
    engine = InferenceEngine.from_trainer(trainer)
    if "INT8_BERT" in cfg.opt:
        engine.quantize()
    return engine


def serve_stdio(engine, inp, out, max_wait_ms: float = 10.0) -> int:
    """Pump JSON-lines from ``inp`` through a BatchingServer, writing
    results to ``out`` in input order (streamed: a result line is emitted
    as soon as its batch completes). Returns the number served."""
    from ruart_tpu_torch.serve import BatchingServer

    n = 0
    with BatchingServer(engine, max_wait_ms=max_wait_ms) as server:
        pending = []
        for line in inp:
            line = line.strip()
            if not line:
                continue
            pending.append(server.submit(json.loads(line)))
            # batches complete in submit order -> flush the done prefix
            while pending and pending[0].done():
                out.write(json.dumps(pending.pop(0).result()) + "\n")
                out.flush()
                n += 1
        for fut in pending:
            out.write(json.dumps(fut.result()) + "\n")
            out.flush()
            n += 1
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description="ruart-tpu PyTorch port serving")
    parser.add_argument("--conf_file", default="conf", help="Path to conf file.")
    parser.add_argument("--log_file", default="", help="Path to log file.")
    parser.add_argument(
        "--max_wait_ms", type=float, default=10.0,
        help="Max micro-batching delay for a lone request.",
    )
    parser.add_argument(
        "--warmup", type=int, default=0, metavar="N",
        help="Capture up to N batch signatures before serving "
             "(0 = none: each signature is captured at its first batch).",
    )
    args = parser.parse_args(argv)

    setup_logging(args.log_file)
    cfg = build_config(args.conf_file)
    apply_runtime_flags(cfg)
    engine = build_engine(cfg)
    with engine:
        if args.warmup > 0:
            ran = engine.warmup(max_programs=args.warmup)
            log.info("warmup ran %d batch signatures", ran)
        print("Serving on stdin (one JSON request per line)", file=sys.stderr)
        n = serve_stdio(engine, sys.stdin, sys.stdout,
                        max_wait_ms=args.max_wait_ms)
    print(f"served {n} requests", file=sys.stderr)
    return n


if __name__ == "__main__":
    main()
