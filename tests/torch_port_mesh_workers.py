"""Rank functions for the port's multi-rank CPU tests
(``test_torch_port_mesh.py``), run in gloo processes started by
``ruart_tpu_torch.parallel.launch.spawn``. This module imports no JAX: each
rank reads its inputs from the work directory the test wrote and writes
its results there.

Work directory: ``opt.json`` (the conf dict), ``bert.json`` (BertConfig
fields), ``state.pt`` (a full state dict), ``batch.npz`` (one collated host
batch: keys ``q/<k>``, ``ocr/<k>``, ``od/<k>``, ``gt``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import GLOBAL_KEYS, RUArtModel
from ruart_tpu_torch.models.fusion.rnn import StackedBRNN
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops.quant import quantize_bert_params
from ruart_tpu_torch.parallel.distributed import maybe_initialize_distributed
from ruart_tpu_torch.parallel.layers import tp_dim
from ruart_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
from ruart_tpu_torch.train.loss import make_loss_fn
from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
from ruart_tpu_torch.train.train_step import (
    dp_gather,
    init_train_state,
    make_train_step,
)


SGD_CLIP = 0.05


def load_inputs(workdir):
    with open(os.path.join(workdir, "opt.json")) as f:
        opt = json.load(f)
    with open(os.path.join(workdir, "bert.json")) as f:
        bert = BertConfig(**json.load(f))
    state = torch.load(os.path.join(workdir, "state.pt"))
    flat = np.load(os.path.join(workdir, "batch.npz"))
    blocks = {"q": {}, "ocr": {}, "od": {}}
    for key in flat.files:
        if key != "gt":
            block, name = key.split("/", 1)
            blocks[block][name] = torch.from_numpy(flat[key])
    batch = (blocks["q"], blocks["ocr"], blocks["od"],
             torch.from_numpy(flat["gt"]))
    return opt, bert, state, batch


def rank_model(opt, bert, state, mesh, dtype="float32"):
    import dataclasses

    spec = ModelSpec.from_config(Config(dict(opt)), dataclasses.replace(
        bert, dtype=dtype))
    model = RUArtModel(spec, mesh)
    model.load_state_dict(shard_params(state, mesh, bert.num_attention_heads))
    return spec, model


def rank_forward(model, batch, mesh):
    """Scores of the global batch: this rank's slice, gathered over dp."""
    q, ocr, od, _ = shard_batch(batch, mesh, batch[3].shape[0], GLOBAL_KEYS)
    model.eval()
    with torch.no_grad():
        return dp_gather(model(q, ocr, od), mesh)


def train_step_on(opt, bert, state, batch, mesh, lock_bert=True,
                  dropout=False, optimizer="#", clip=None):
    """One train step on ``mesh``: (loss, the model). ``dropout``: the
    shipped conf's DROPOUT 0.3 and dropout_emb 0.4."""
    opt = dict(opt)
    if not lock_bert:
        opt.pop("LOCK_BERT")
    if dropout:
        opt.update(DROPOUT=0.3, dropout_emb=0.4)
    spec, model = rank_model(opt, bert, state, mesh)
    optimizer = Optimizer(optimizer, float(opt["lr"]),
                          clip or float(opt.get("grad_clipping", 10)), model,
                          spec, True, mesh=mesh)
    step = make_train_step(
        make_loss_fn("BCE_D1"),
        make_row_pinner(model, spec, int(opt["tune_partial"])), mesh=mesh)
    st = init_train_state(model, optimizer, 0)
    q, ocr, od, gt = shard_batch(batch, mesh, batch[3].shape[0], GLOBAL_KEYS)
    _, loss = step(st, q, ocr, od, gt)
    return loss, model


def full_params(model, mesh):
    """The full parameters (tp shards gathered) on every rank."""
    out = {}
    for name, p in model.named_parameters():
        dim = tp_dim(p)
        if dim is not None:
            parts = [torch.empty_like(p) for _ in range(mesh.tp)]
            dist.all_gather(parts, p.detach().contiguous(),
                            group=mesh.tp_group)
            p = torch.cat(parts, dim=dim)
        out[name] = p.detach()
    return out


def forward_ranks(rank, world, address, workdir):
    """Four ranks: (dp 2) on ranks 0-1 and (tp 2) on ranks 2-3 at once,
    then (dp 2, tp 2) on all four; the tp-2 and (dp 2, tp 2) forwards under
    INT8_BERT; then one dp-2 train step on ranks 0-1
    (and the dp-2 forward with per-rank layer-norm moments, and a dp-2
    step with dropout) while ranks
    2-3 run the tp-2 forward in bf16, recording the row-parallel reduces'
    dtypes, and a tp-2 step with the encoder unlocked; last, two
    (dp 2, tp 2) train steps on all four: Adamax, and SGD with the encoder
    unlocked and a clip that binds (SGD's update is proportional to the
    clip's scale)."""
    maybe_initialize_distributed({"coordinator_address": address,
                                  "num_processes": world,
                                  "process_id": rank}, "cpu")
    opt, bert, state, batch = load_inputs(workdir)
    dp2 = make_mesh([0, 1], tp=1)
    tp2 = make_mesh([2, 3], tp=2)
    both = make_mesh(range(4), tp=2)
    out = {}

    mesh = dp2 or tp2
    _, model = rank_model(opt, bert, state, mesh)
    out["dp2" if dp2 else "tp2"] = rank_forward(model, batch, mesh)
    _, model = rank_model(opt, bert, state, both)
    out["dp2tp2"] = rank_forward(model, batch, both)
    # INT8_BERT: the int8 layers whole on every rank, the word tables split
    int8_opt, int8 = dict(opt, INT8_BERT=True), quantize_bert_params(state)
    if tp2 is not None:
        _, model = rank_model(int8_opt, bert, int8, tp2)
        out["tp2_int8"] = rank_forward(model, batch, tp2)
    _, model = rank_model(int8_opt, bert, int8, both)
    out["dp2tp2_int8"] = rank_forward(model, batch, both)

    if dp2 is not None:
        spec, model = rank_model(opt, bert, state, dp2)
        for mod in model.modules():
            if isinstance(mod, StackedBRNN):
                mod.ln_group = None
        out["dp2_rank_moments"] = rank_forward(model, batch, dp2)
        loss, model = train_step_on(opt, bert, state, batch, dp2)
        out["dp2/loss"] = loss
        out.update({f"dp2/param/{k}": v for k, v in
                    full_params(model, dp2).items()})
        loss, model = train_step_on(opt, bert, state, batch, dp2,
                                    dropout=True)
        out["dp2_dropout/loss"] = loss
        out.update({f"dp2_dropout/param/{k}": v for k, v in
                    full_params(model, dp2).items()})
    else:
        from ruart_tpu_torch.models.bert import model as bert_model

        dtypes = set()
        reduce = bert_model.all_reduce

        def record(x, group):
            dtypes.add(str(x.dtype))
            return reduce(x, group)

        bert_model.all_reduce = record
        _, model = rank_model(opt, bert, state, tp2, dtype="bfloat16")
        out["tp2_bf16"] = rank_forward(model, batch, tp2)
        bert_model.all_reduce = reduce
        with open(os.path.join(workdir, f"dtypes_{rank}.json"), "w") as f:
            json.dump(sorted(dtypes), f)
        loss, model = train_step_on(opt, bert, state, batch, tp2,
                                    lock_bert=False)
        out["tp2_unlocked/loss"] = loss
        out.update({f"tp2_unlocked/param/{k}": v for k, v in
                    full_params(model, tp2).items()})
    loss, model = train_step_on(opt, bert, state, batch, both)
    out["dp2tp2/loss"] = loss
    out.update({f"dp2tp2/param/{k}": v for k, v in
                full_params(model, both).items()})
    loss, model = train_step_on(opt, bert, state, batch, both,
                                lock_bert=False, optimizer="SGD",
                                clip=SGD_CLIP)
    out["dp2tp2_sgd/loss"] = loss
    out.update({f"dp2tp2_sgd/param/{k}": v for k, v in
                full_params(model, both).items()})

    if rank in (0, 2):
        torch.save({k: v.numpy() for k, v in out.items()},
                   os.path.join(workdir, f"out_{rank}.pt"))
    dist.destroy_process_group()


def trainer_ranks(rank, world, address, workdir, opt):
    """Two ranks through the conf keys: ``Trainer.train`` (2 steps, eval,
    best-model saves), a full ``save``, the scores of the first val batch,
    and again through the INT8_BERT eval model; then a trainer whose batch dp does not divide. Records which ranks
    wrote checkpoint files."""
    from ruart_tpu_torch.train import checkpoint as ckpt
    from ruart_tpu_torch.train.trainer import Trainer

    opt = dict(opt, coordinator_address=address, num_processes=world,
               process_id=rank)
    with open(os.path.join(workdir, "bert.json")) as f:
        bert = BertConfig(**json.load(f))
    written = []
    write = ckpt._write

    def record(path, arrays, meta):
        written.append(os.path.basename(path))
        write(path, arrays, meta)

    ckpt._write = record
    trainer = Trainer(Config(dict(opt)), bert_config=bert, device="cpu")
    trainer.train(eval_every=10 ** 6, log_every=10 ** 6)
    trainer.save(os.path.join(workdir, "full.ckpt"))
    scores = first_val_scores(trainer)
    trainer._apply_int8_eval()  # INT8_BERT's eval model under tp
    np.save(os.path.join(workdir, f"scores_int8_{rank}.npy"),
            first_val_scores(trainer))

    small = dict(opt, batch_size=3)
    small.pop("tensor_parallel", None)
    other = Trainer(Config(small), bert_config=bert, device="cpu")
    _, _, embeddings = other._preprocess()
    other.setup_model(embeddings)
    result = {"written": written, "updates": trainer.updates,
              "mesh": trainer.mesh.shape, "loss": trainer.train_loss.avg,
              "save_folder": trainer.save_folder,
              "small_batch_mesh": other.mesh is not None}
    with open(os.path.join(workdir, f"trainer_{rank}.json"), "w") as f:
        json.dump(result, f)
    np.save(os.path.join(workdir, f"scores_{rank}.npy"), scores)
    dist.destroy_process_group()


def first_val_scores(trainer) -> np.ndarray:
    """Scores of the first ``batch_size`` val items through the trainer's
    eval step (gathered over dp on a mesh)."""
    val = trainer._dataset(trainer._load_split("val"), "dev")
    batch = trainer.collator([val[i] for i in range(trainer.cfg.batch_size)])
    q, ocr, od, gt, _ = trainer._device_put(trainer._host_put(batch))
    scores, _ = trainer.eval_step(q, ocr, od, gt)
    return scores.numpy()
