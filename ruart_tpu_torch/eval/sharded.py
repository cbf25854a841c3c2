"""Data-parallel evaluation over a rank mesh — port of
``ruart_tpu/eval/sharded.py``.

Replaces the reference's sequential single-device eval loop + host-side
result accumulation (`SDNetTrainer.py:133-144`) with dp-sharded batches:
every rank holds the model (its tp shard of it), keeps its dp slice of
each batch, runs the eval step on it, and only the small [B, C] score
matrix is gathered over dp for decoding.
"""

from __future__ import annotations

from ruart_tpu_torch.models.fusion.model import GLOBAL_KEYS, RUArtModel
from ruart_tpu_torch.parallel.distributed import make_global_batch
from ruart_tpu_torch.parallel.mesh import shard_batch
from ruart_tpu_torch.train.train_step import make_eval_step


def put_local_batch(batch, mesh, device):
    """A host (q, ocr, od, gt, extra) batch -> this rank's dp slice of it on
    ``device``: per-sample rows sliced, the batch-global tables
    (``GLOBAL_KEYS``) whole, ``extra`` as it is (global)."""
    q, ocr, od, gt, extra = batch
    n = ocr["num"].shape[0]
    local = shard_batch((q, ocr, od, gt), mesh, n, GLOBAL_KEYS)
    q, ocr, od, gt = make_global_batch(local, mesh, device, n_global=n,
                                       replicated_keys=GLOBAL_KEYS)
    return q, ocr, od, gt, extra


def make_sharded_eval(model: RUArtModel, loss_fn, mesh, device,
                      debug_nans: bool = False):
    """Returns (eval_step, device_put) ready for
    ``ruart_tpu_torch.eval.evaluator.evaluate``: pass ``device_put`` so each
    host batch lands on ``device`` as this rank's dp slice
    (:func:`put_local_batch`); the step gathers the scores over dp.
    ``model`` already holds this rank's parameters (``RUArtModel(spec,
    mesh)`` loaded with ``parallel.mesh.shard_params``), where the JAX
    function places the parameter tree on the mesh."""
    eval_step = make_eval_step(model, loss_fn, mesh, debug_nans)

    def device_put(batch):
        return put_local_batch(batch, mesh, device)

    return eval_step, device_put
