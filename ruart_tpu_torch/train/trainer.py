"""Trainer: end-to-end orchestration (train / eval / test inference) on one
device — port of ``ruart_tpu/train/trainer.py``.

The equivalent of `Models/SDNetTrainer.py` + `BaseTrainer.py`: run-folder
allocation (``conf~/run_<N>``), conf snapshotting, preprocessing
bootstrap, model/optimizer setup, the training loop with its 1500-batch
eval cadence and 30-batch log cadence, best-ANLS/ACC checkpointing, exact
sampler-offset resume, and ``predict_for_test``, which writes
``submission.json``.

The trainer runs on the CUDA card unless the caller passes ``device="cpu"``
(the CLIs do so under ``RUART_PLATFORM=cpu``); without a card it raises.
``INT8_BERT`` is an inference-time transform, as in the JAX package: the
stateful model, its checkpoints and training stay fp32, and
``predict_for_test`` evaluates a weight-only int8 copy of the loaded
weights. ``BF16`` trains and evaluates the encoder in bf16 over fp32
weights (each Linear casts its weight per call, as flax does).
``fixed_answers`` reads the answer list and labels and ``img_feature`` the
image features at construction, as the JAX trainer does.

Mesh execution (``ruart_tpu/train/trainer.py:241-393``): with
``coordinator_address`` the trainer joins a ``torch.distributed`` world
(``parallel/distributed.py``; one rank per card). With several ranks and
no ``no_mesh`` it builds the (dp, tp) rank mesh (``tensor_parallel`` sets
tp) when dp divides ``batch_size``, and otherwise stays on its one device
and logs so, as the JAX trainer does. On the mesh every rank builds the
same seeded full model, keeps its tp shard, collates the full global batch
and keeps its dp slice (``_device_put``); rank 0 alone picks the run
folder, preprocesses, and writes checkpoints (tp shards gathered to it)
and ``submission.json``. A process that sees several cards without a
world drives one of them; ``cli.main`` starts one rank per card.
``debug_nans`` (the CLI key) and ``DEBUG_NANS`` check every step's outputs
for NaN/Inf (``train_step``). On one card the train and eval steps replay
one CUDA graph per batch signature (``train_step.make_train_step`` and
``make_eval_step``); each train step hands back a loss of its own, which
``DEBUG_SDT`` prints and the log cadence stacks. :meth:`Trainer.train`
releases the train step's graphs when its steps are done, and an eval step
that is replaced releases its graphs first. ``DEBUG`` makes
:meth:`Trainer.train` a dry run of the data path: it scans every split
without the model, writes the length histograms (``data/debug.py``) and
returns.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
from typing import Dict, Optional

import msgpack
import numpy as np
import torch
import torch.distributed as dist

from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.debug import dump_debug_scan
from ruart_tpu_torch.data.image_features import load_image_features
from ruart_tpu_torch.data.pipeline import (
    batch_iterator,
    device_put_batch,
    host_batch,
    prefetch,
)
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.data.sampler import VQASampler
from ruart_tpu_torch.eval.evaluator import evaluate, write_submission
from ruart_tpu_torch.eval.sharded import make_sharded_eval, put_local_batch
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.bert.convert import load_bert_params
from ruart_tpu_torch.models.fusion.model import RUArtModel, install_embeddings
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops.attention import tp_kernel_ok
from ruart_tpu_torch.ops.quant import quantize_bert_params
from ruart_tpu_torch.parallel.distributed import (
    fetch_local_first,
    local_device_id,
    make_hybrid_mesh,
    maybe_initialize_distributed,
    world_rank,
    world_size,
)
from ruart_tpu_torch.parallel.layers import tp_dim
from ruart_tpu_torch.parallel.mesh import shard_params, shard_tensor
from ruart_tpu_torch.serve import resolve_device
from ruart_tpu_torch.text.phoc import build_phoc_batch
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from ruart_tpu_torch.train import checkpoint as ckpt
from ruart_tpu_torch.train.loss import make_loss_fn
from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
from ruart_tpu_torch.train.train_step import (
    init_train_state,
    make_eval_step,
    make_train_step,
)
from ruart_tpu_torch.utils.graphs import release
from ruart_tpu_torch.utils.meters import AverageMeter

log = logging.getLogger(__name__)


def resolve_bert_artifacts(opt: Dict) -> tuple:
    """(tokenizer_file, model_dir) conf values, honoring the BERT_LARGE
    redirection to the *_large_* keys (`VQA_Dataset.py:49-58`,
    `Bert/Bert.py:26-28`)."""
    if "BERT_LARGE" in opt:
        tok = opt.get("BERT_large_tokenizer_file", opt.get("BERT_tokenizer_file"))
        mdl = opt.get("BERT_large_model_file", opt.get("BERT_model_file"))
        return tok, mdl
    return opt.get("BERT_tokenizer_file"), opt.get("BERT_model_file")


class Trainer:
    def __init__(self, cfg: Config, bert_config: Optional[BertConfig] = None,
                 device=None):
        self.cfg = cfg
        self.opt = cfg.opt
        # join the world before anything sees the device (a no-op without
        # the coordinator_address conf key — parallel/distributed.py)
        device = resolve_device(device)
        if maybe_initialize_distributed(self.opt, device.type) and (
                device.type == "cuda"):
            device = torch.device("cuda", local_device_id(self.opt))
        self.device = device
        self._n_proc = world_size()
        self._rank0 = world_rank() == 0
        if (self.device.type == "cuda" and torch.cuda.device_count() > 1
                and self._n_proc == 1 and "no_mesh" not in self.opt):
            log.warning(
                "%d visible cards: this process drives %s alone; "
                "`python -m ruart_tpu_torch.cli.main` starts one rank per "
                "card", torch.cuda.device_count(), self.device)
        self.mesh = None
        self._full_model = None
        self.opt.setdefault("datadir", ".")
        self.opt["FEATURE_FOLDER"] = os.path.join(
            self.opt["datadir"], "./source/data/", str(self.opt.get("source_dir", "")), ""
        ) if "FEATURE_FOLDER" not in self.opt else self.opt["FEATURE_FOLDER"]
        self.preproc = Preprocessor(cfg)
        self.bert_config = bert_config
        self.save_folder: Optional[str] = None
        self.train_loss = AverageMeter()
        self.updates = 0
        self.best_anls = -1.0
        self.best_acc = -1.0
        self.best_anls_batch = -1
        self.best_acc_batch = -1
        # host-clock records of the last train() / run_eval() calls
        self.train_seconds = 0.0
        self.eval_history: list = []
        self._load_fixed_answers()
        self._load_image_features()

    # -- folders (`BaseTrainer.py:48-69`) --------------------------------
    def get_save_folder(self, is_train: bool) -> str:
        if is_train:
            # rank 0 picks the run folder; the other ranks take its pick
            folder = [None]
            runid = 1
            while self._rank0:
                folder[0] = os.path.join(self.opt["datadir"], "conf~",
                                         f"run_{runid}")
                if not os.path.exists(folder[0]):
                    os.makedirs(folder[0])
                    log.info("Saving logs, model and evaluation in %s",
                             folder[0])
                    break
                runid += 1
            if self._n_proc > 1:
                dist.broadcast_object_list(folder, src=0)
            self.save_folder = folder[0]
            return self.save_folder
        p = "/".join(str(self.opt["MODEL_PATH"]).split("/")[:2])
        self.save_folder = os.path.join(self.opt["datadir"], p)
        os.makedirs(self.save_folder, exist_ok=True)
        return self.save_folder

    def save_conf_copy(self):
        conf_file = self.opt.get("confFile")
        if (conf_file and os.path.isfile(conf_file) and self.save_folder
                and self._rank0):
            shutil.copyfile(conf_file, os.path.join(self.save_folder, "conf_copy"))

    # -- fixed answers (`SDNetTrainer.py:253-288`) -----------------------
    def _load_fixed_answers(self):
        self.fixed_answers_entry = None
        self.fixed_answers = None
        if "fixed_answers" not in self.opt:
            return
        folder = self.opt["fixed_answers_folder"]
        with open(os.path.join(folder, "fixed_answers_4000.txt")) as f:
            fixed = [line.strip().lower() for line in f if line.strip()]
        label_path = os.path.join(
            folder, "TRAIN_VAL_fixed_answers_label.msgpack"
        )
        labels = {}
        if os.path.exists(label_path):
            with open(label_path, "rb") as f:
                labels = msgpack.unpack(f, raw=False, strict_map_key=False)
        # built for parity with the JAX trainer; no model reads it
        phoc = None
        if "phoc" in self.opt.get("ocr_embedding", ""):
            phoc = build_phoc_batch(fixed)
        self.fixed_answers = fixed
        self.fixed_answers_entry = {
            "fixed_answers": fixed,
            "fixed_answers_len": len(fixed),
            "fixed_answers_label": labels,
            "fixed_answers_phoc": phoc,
        }
        self.opt["fixed_answers_len"] = len(fixed)

    def _load_image_features(self):
        """`SDNetTrainer.load_image_features:178-207` hook."""
        self.image_features = load_image_features(self.opt)
        if self.image_features is not None:
            log.info("Image features have been loaded")

    def _preprocess(self):
        """``ensure_preprocessed`` on rank 0 first: the other ranks wait,
        then find the files written."""
        if self._rank0:
            self.preproc.ensure_preprocessed()
        if self._n_proc > 1:
            dist.barrier()
            self.preproc.ensure_preprocessed()
        return self.preproc.load_data()

    # -- model setup (`SDNetTrainer.setup_model:290-328`) ----------------
    def setup_model(self, embeddings: Dict[str, np.ndarray]):
        cfg = self.cfg
        tok_file, bert_dir = resolve_bert_artifacts(self.opt)
        self.tokenizer = WordPieceTokenizer(build_demo_vocab())
        if tok_file:
            tok_path = os.path.join(self.opt["datadir"], str(tok_file))
            if os.path.isfile(tok_path):
                self.tokenizer = WordPieceTokenizer.from_file(tok_path)
            else:
                log.warning("BERT vocab %s missing; using demo vocab", tok_path)
        # the BERT embedding table must cover every tokenizer id
        if self.bert_config is not None and self.bert_config.vocab_size < len(
            self.tokenizer.vocab
        ):
            self.bert_config = dataclasses.replace(
                self.bert_config, vocab_size=len(self.tokenizer.vocab)
            )
        self.spec = ModelSpec.from_config(cfg, self.bert_config)
        # INT8_BERT is an inference-time transform: the stateful model
        # (init / checkpoints / training) stays fp32, and predict_for_test
        # quantizes the loaded weights into a separate eval model
        # (_apply_int8_eval), so checkpoints never hold int8 weights
        self._int8_eval = (self.spec.bert is not None
                           and self.spec.bert.quant == "int8")
        if self._int8_eval:
            self.spec = dataclasses.replace(
                self.spec, bert=dataclasses.replace(self.spec.bert, quant="none")
            )
        # random init on the host from a seeded generator (the same weights
        # on every device), then the pretrained tables
        model = RUArtModel(self.spec).init_weights(
            torch.Generator().manual_seed(cfg.seed)
        )
        install_embeddings(
            model,
            glove=embeddings.get("glove_embedding"),
            fasttext=embeddings.get("fast_embedding"),
            phoc=embeddings.get("phoc_embedding"),
        )
        if bert_dir:
            bert_path = os.path.join(self.opt["datadir"], str(bert_dir))
            cfg_json = os.path.join(bert_path, "bert_config.json")
            bin_path = os.path.join(bert_path, "pytorch_model.bin")
            if os.path.isfile(cfg_json) and os.path.isfile(bin_path):
                _, state = load_bert_params(bert_path)
                model.load_state_dict(state, strict=False)
                log.info("Loaded pretrained BERT from %s", bert_path)
        self.collator = Collator(cfg)
        self._h2d_slim = bool(int(cfg.opt.get("h2d_slim", 1)))
        self._setup_mesh(model)

        tune_partial = (
            int(self.opt["tune_partial"]) if "TUNE_PARTIAL" in self.opt else None
        )
        self.optimizer = Optimizer(
            str(self.opt.get("optimizer", "#")),
            float(self.opt["lr"]) if "lr" in self.opt else None,
            float(self.opt.get("grad_clipping", 10)),
            self.model,
            self.spec,
            tune_partial is not None,
            mesh=self.mesh,
        )
        self.loss_fn = make_loss_fn(str(self.opt.get("loss", "BCE_D1")))
        row_pinner = make_row_pinner(self.model, self.spec, tune_partial)
        self._debug_nans = "DEBUG_NANS" in self.opt or "debug_nans" in self.opt
        self.train_step = make_train_step(
            self.loss_fn, row_pinner, debug_nans=self._debug_nans,
            mesh=self.mesh,
        )
        if self.mesh is not None:
            self.eval_step, _ = make_sharded_eval(
                self.model, self.loss_fn, self.mesh, self.device,
                self._debug_nans)
        else:
            self.eval_step = make_eval_step(self.model, self.loss_fn,
                                            debug_nans=self._debug_nans)
        self.state = init_train_state(self.model, self.optimizer, cfg.seed)
        self.updates = 0

    def _setup_mesh(self, model: RUArtModel):
        """Mesh execution when several ranks run and dp divides the batch
        (`trainer.py:241-311`): this rank's shard of the seeded full
        ``model``, whose copy stays on the host for saves under tp.
        Otherwise ``model`` itself, on this rank's device."""
        self.mesh = None
        self._full_model = None
        if self._n_proc > 1 and "no_mesh" not in self.opt:
            tp = int(self.opt.get("tensor_parallel", 1))
            mesh = make_hybrid_mesh(tp=tp)
            if self.cfg.batch_size % mesh.dp == 0:
                self.mesh = mesh
                log.info("Mesh execution: dp=%d tp=%d over %d ranks",
                         mesh.dp, mesh.tp, self._n_proc)
            else:
                log.info(
                    "batch %d not divisible by dp=%d, staying single-device"
                    "%s", self.cfg.batch_size, mesh.dp,
                    " (ModelParallel conf key noted)"
                    if "ModelParallel" in self.opt else "")
        if self.mesh is None:
            self.model = model.to(self.device)
            return
        bert = self.spec.bert
        heads = bert.num_attention_heads if bert is not None else None
        if bert is not None:
            dh = bert.hidden_size // heads
            if tp_kernel_ok(heads, dh, self.mesh.tp):
                log.info("tp=%d: the attention kernel runs on %d local heads "
                         "per rank", self.mesh.tp, heads // self.mesh.tp)
            else:
                log.info("tp=%d does not divide %d heads: the attention "
                         "layers stay whole on every rank", self.mesh.tp,
                         heads)
        with self.device:
            local = RUArtModel(self.spec, self.mesh)
        local.load_state_dict(shard_params(model.state_dict(), self.mesh,
                                           heads))
        self.model = local
        if self.mesh.tp > 1:
            self._full_model = model

    # -- checkpoint plumbing --------------------------------------------
    def _host_model(self, skip: str = "", everywhere: bool = False
                    ) -> Optional[RUArtModel]:
        """The full model, on rank 0 (None elsewhere) or on every rank with
        ``everywhere``: under tp the host copy filled with this rank's tp
        row's shards (gathered; every rank takes part), else the model
        itself. Names starting with ``skip`` are not gathered."""
        keep = self._rank0 or everywhere
        if self._full_model is None:
            return self.model if keep else None
        full = {}
        for name, p in self.model.named_parameters():
            if not (skip and name.startswith(skip)):
                full[name] = fetch_local_first(p, self.mesh, tp_dim(p),
                                               materialize=keep)
        if not keep:
            return None
        self._full_model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in full.items()}, strict=False)
        return self._full_model

    def _host_opt_state(self) -> Optional[Dict[str, np.ndarray]]:
        """The optimizer state to write, on rank 0 (tp shards gathered)."""
        state = self.optimizer.state_dict()
        if self._full_model is None:
            return state if self._rank0 else None
        params = dict(self.model.named_parameters())
        out = {"count": state["count"]}
        for name, st in self.optimizer.state.items():
            for slot, value in st.items():
                out[f"{slot}/{name}"] = fetch_local_first(
                    value, self.mesh, tp_dim(params[name]),
                    materialize=self._rank0)
        return out if self._rank0 else None

    def save(self, filename: str, epoch: int = 0):
        model = self._host_model()
        opt_state = self._host_opt_state()
        if not self._rank0:
            return  # every rank gathers, rank 0 writes
        meta = {
            "updates": self.updates,
            "train_loss": self.train_loss.state_dict(),
            "epoch": epoch,
            "config": {k: v for k, v in self.opt.items() if _json_safe(v)},
        }
        ckpt.save_checkpoint(filename, model, opt_state, meta)

    def save_for_predict(self, filename: str):
        model = self._host_model(skip="Bert.")
        if self._rank0:
            ckpt.save_for_predict(filename, model, {"updates": self.updates})

    def load_model(self, path: str, with_optimizer: bool = True):
        """Key-intersection load of the parameters; the optimizer state too
        unless ``with_optimizer`` is False (prediction never steps). Under
        tp the checkpoint loads into the host copy, and each rank keeps its
        shards of it."""
        target = self._full_model or self.model
        opt_arrays, jax_opt, meta = ckpt.load_checkpoint(path, target)
        if self._full_model is not None:
            heads = self.spec.bert.num_attention_heads if self.spec.bert else None
            self.model.load_state_dict(
                shard_params(target.state_dict(), self.mesh, heads))
            if opt_arrays is not None:
                dims = {n: tp_dim(p) for n, p in self.model.named_parameters()}
                opt_arrays = {
                    k: v if k == "count" else shard_tensor(
                        torch.from_numpy(v), dims.get(k.split("/", 1)[1]),
                        self.mesh).numpy()
                    for k, v in opt_arrays.items()
                }
        if with_optimizer:
            ckpt.restore_optimizer(
                self.optimizer, opt_arrays, jax_opt,
                strict="LENIENT_OPT_RESUME" not in self.opt,
            )
        self.updates = int(meta.get("updates", 0))
        if "train_loss" in meta:
            self.train_loss.load_state_dict(meta["train_loss"])
        log.info("Loading finished %s", path)

    def _resume_path(self) -> Optional[str]:
        if "RESUME" in self.opt and "MODEL_PATH" in self.opt:
            model_path = os.path.join(self.opt["datadir"], self.opt["MODEL_PATH"])
            if not os.path.exists(model_path):
                # a typo'd MODEL_PATH must not silently train from scratch
                # or emit a random-weights submission
                raise FileNotFoundError(f"RESUME checkpoint not found: {model_path}")
            return model_path
        return None

    # -- data loading ----------------------------------------------------
    def _load_split(self, label: str):
        path = os.path.join(
            self.opt["FEATURE_FOLDER"], f"{label}-preprocessed.msgpack"
        )
        with open(path, "rb") as f:
            return msgpack.unpack(f, raw=False, strict_map_key=False)

    def _dataset(self, label_data, mode: str) -> VQADataset:
        return VQADataset(
            label_data["data"], self.cfg, mode=mode, tokenizer=self.tokenizer,
            fixed_answers_entry=self.fixed_answers_entry,
            image_features=self.image_features,
        )

    def _host_put(self, batch):
        return host_batch(batch, self.spec, self._h2d_slim,
                          pin=self.device.type == "cuda")

    def _device_put(self, batch):
        """A :meth:`_host_put` batch -> (q, ocr, od, gt, extra) on this
        rank's device. On the mesh (`trainer.py:318-353`) every rank holds
        the full global batch and keeps its dp slice of the per-sample
        rows; the batch-global tables stay whole, so L and every table
        agree across ranks (``eval.sharded.put_local_batch``)."""
        if self.mesh is None:
            return device_put_batch(batch, self.device)
        return put_local_batch(batch, self.mesh, self.device)

    # -- evaluation (`SDNetTrainer.evaluate:128-176`) --------------------
    def run_eval(self, dataset: VQADataset, batch_i: int, mode: str = "dev"):
        t0 = time.perf_counter()
        result = evaluate(
            self.eval_step, dataset, self.cfg, self.spec, self.device,
            self.collator, fixed_answers=self.fixed_answers,
            device_put=self._device_put,
        )
        self.eval_history.append({
            "mode": mode, "batch": batch_i, "n": result["n"],
            "seconds": time.perf_counter() - t0,
            "ANLS": result["ANLS"], "ACC": result["ACC"],
        })
        if mode == "test":
            if self._rank0:
                # every rank decodes the gathered scores; one writes
                write_submission(
                    result["res"], self.save_folder, result["n"],
                    self.cfg.batch_size,
                )
            return result
        if mode == "dev" and self.save_folder:
            if self._rank0:
                with open(os.path.join(self.save_folder,
                                       "save_res_last.json"), "w") as f:
                    json.dump(result["save_res"], f, indent=2)
            if result["ANLS"] > self.best_anls:
                self.best_anls = result["ANLS"]
                self.best_anls_batch = batch_i
                self.save_for_predict(
                    os.path.join(self.save_folder, "ANLS_best_model.ckpt")
                )
            if result["ACC"] > self.best_acc:
                self.best_acc = result["ACC"]
                self.best_acc_batch = batch_i
                self.save_for_predict(
                    os.path.join(self.save_folder, "ACC_best_model.ckpt")
                )
        log.info(
            "Dataset: %s Batch: %7d ANLS: %.3f Best ANLS: %.3f Batch: %d "
            "ACC: %.3f Best ACC: %.3f Batch: %d",
            mode, batch_i, result["ANLS"], self.best_anls, self.best_anls_batch,
            result["ACC"], self.best_acc, self.best_acc_batch,
        )
        return result

    # -- training loop (`SDNetTrainer.train:52-126`) ---------------------
    def train(self, eval_every: int = 1500, log_every: int = 30):
        self.get_save_folder(is_train=True)
        self.save_conf_copy()
        vocab, char_vocab, embeddings = self._preprocess()
        self.vocab = vocab
        self.setup_model(embeddings)
        model_path = self._resume_path()
        if model_path is not None:
            self.load_model(model_path)
        if "DEBUG" in self.opt:
            # data-path dry run: iterate every split through the pipeline
            # without touching the model and dump length histograms
            # (`SDNetTrainer.py:67-79`; a return instead of assert False)
            for label in ("train", "val", "test"):
                try:
                    raw = self._load_split(label)
                except FileNotFoundError:
                    continue
                ds = self._dataset(raw, "test" if label == "test" else "train")
                if self._rank0:
                    paths = dump_debug_scan(ds, label, self.save_folder or ".")
                    log.info("DEBUG scan %s -> %s", label, paths)
            log.info("DEBUG data dry run complete")
            return

        train_data = self._dataset(self._load_split("train"), "train")
        val_data = self._dataset(self._load_split("val"), "dev")
        batch_st = int(self.opt.get("batch_st", 0))
        sampler = VQASampler(
            len(train_data), self.cfg.batch_size, train=True,
            max_batch_number=int(self.opt.get("max_batch_num", 0)) or None,
            batch_st=batch_st,
            epoch=self.opt.get("epoch"),
        )
        it = batch_iterator(
            train_data, sampler, self.collator,
            num_workers=int(self.opt.get("num_worker", 0)),
        )
        start = time.time()
        batch_i = batch_st - 1
        # per-step device losses wait here and are read only at log_every
        # cadence: a per-step .item() would stall the host on every step
        # (the reference's habit, `SDNetTrainer.py:362`). The finite-loss
        # check therefore fires up to log_every-1 batches late, on a stale
        # loss (the reference asserts at once, `SDNetTrainer.py:352-359`).
        pending: list = []

        def drain_losses(at_batch: int):
            if not pending:
                return None
            vals = torch.stack(pending).double().cpu().numpy()
            pending.clear()
            if not np.isfinite(vals).all():
                first = at_batch - len(vals) + 1 + int(
                    np.argmax(~np.isfinite(vals))
                )
                raise FloatingPointError(f"loss is not finite at batch {first}")
            for v in vals:
                self.train_loss.update(float(v), 1)
            return float(vals[-1])

        eval_seconds = 0.0
        for host in prefetch(it, size=2, host_put=self._host_put):
            q, ocr, od, gt, extra = self._device_put(host)
            batch_i += 1
            if batch_i % eval_every == 0:
                drain_losses(batch_i - 1)
                t0 = time.time()
                self.run_eval(val_data, batch_i)
                eval_seconds += time.time() - t0
            self.state, loss = self.train_step(self.state, q, ocr, od, gt)
            self.updates += 1
            pending.append(loss)
            if "DEBUG_SDT" in self.opt:
                # opt-in per-step debug print (`SDNetTrainer.py:361-362`);
                # the float() here is a deliberate host sync — debug only
                print(float(loss), [t.get("q_id") for t in extra])
            if batch_i % log_every == 0:
                loss_val = drain_losses(batch_i)
                done = batch_i - batch_st + 1
                rate = (time.time() - start) / max(done, 1)
                remaining = rate * (len(sampler) - batch_st - done)
                log.info(
                    "updates[%6d] train loss[%8.5f / %8.5f] remaining[%ds]",
                    self.updates, self.train_loss.avg, loss_val, int(remaining),
                )
        drain_losses(batch_i)
        self.train_seconds = time.time() - start - eval_seconds
        self.train_step.release()  # training is over: its graphs go now
        self.run_eval(val_data, batch_i)
        self.run_eval(train_data, batch_i, mode="train")
        log.info("Training over")

    # -- test inference (`SDNetTrainer.predict_for_test:231-251`) --------
    def predict_for_test(self):
        self.get_save_folder(is_train=False)
        vocab, char_vocab, embeddings = self._preprocess()
        self.setup_model(embeddings)
        test_raw = self._load_split("test")
        model_path = self._resume_path()
        if model_path is not None:
            self.load_model(model_path, with_optimizer=False)
        if self._int8_eval:
            self._apply_int8_eval()
        test_data = self._dataset(test_raw, "test")
        return self.run_eval(test_data, 0, mode="test")

    def _apply_int8_eval(self):
        """Swap the eval step to a weight-only-int8 copy of the encoder
        (INT8_BERT). Runs after the checkpoint load, so the int8 weights
        reflect the loaded fp32 ones; the stateful fp32 model is kept.
        Under tp every rank gathers the full weights, quantizes them and
        keeps its shards: the int8 layers whole, the word tables split
        (``parallel.mesh.param_shardings``)."""
        qspec = dataclasses.replace(
            self.spec, bert=dataclasses.replace(self.spec.bert, quant="int8")
        )
        with self.device:
            qmodel = RUArtModel(qspec, self.mesh)
        params = quantize_bert_params(
            self._host_model(everywhere=True).state_dict())
        if self.mesh is not None:
            params = shard_params(params, self.mesh,
                                  qspec.bert.num_attention_heads)
        qmodel.load_state_dict(params)
        release(self.eval_step)
        self.eval_step = make_eval_step(qmodel, self.loss_fn, self.mesh,
                                        self._debug_nans)
        log.info("INT8_BERT: encoder Linear layers quantized for inference")


def _json_safe(v) -> bool:
    return isinstance(v, (str, int, float, bool, type(None)))
