"""The port's host pipeline and small training pieces, on the CPU:
the sampler against the JAX package's (the same batches), prefetch,
the two-half put (aliases, index checks), the evaluator's pad-tail trim,
the meter, the ``DEBUG_NANS`` checks, and the conf branches the trainer
refuses by name.
"""

import numpy as np
import pytest
import torch

from ruart_tpu.data.sampler import VQASampler as JaxSampler
from ruart_tpu.eval.evaluator import trim_pad_tail as jax_trim_pad_tail
from ruart_tpu_torch.core.config import Config, read_conf_lines
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.data import pipeline
from ruart_tpu_torch.data.sampler import VQASampler
from ruart_tpu_torch.eval.evaluator import trim_pad_tail
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.train.train_step import _check_inputs
from ruart_tpu_torch.train.trainer import Trainer
from ruart_tpu_torch.utils.meters import AverageMeter

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(data_count=37, batch_size=8, train=True, epoch=3),
    dict(data_count=37, batch_size=8, train=True, max_batch_number=9, batch_st=4),
    dict(data_count=37, batch_size=8, train=False),
], ids=["train-epochs", "train-resume", "eval-wrap"])
def test_sampler_matches_jax(kw):
    assert list(VQASampler(**kw)) == list(JaxSampler(**kw))
    assert len(VQASampler(**kw)) == len(JaxSampler(**kw))


def test_trim_pad_tail_matches_jax():
    res = list(range(16))
    for n in (16, 13, 9):
        assert trim_pad_tail(res, n, 8) == jax_trim_pad_tail(res, n, 8)


def test_prefetch_order_and_error():
    assert list(pipeline.prefetch(iter(range(7)), size=2,
                                  host_put=lambda x: x * 10)) == [
        0, 10, 20, 30, 40, 50, 60]

    def broken():
        yield 1
        raise KeyError("boom")

    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in pipeline.prefetch(broken()):
            got.append(x)
    assert got == [1]


def test_worker_pool_is_refused(monkeypatch):
    """``num_worker`` is ported and no longer refused: its batches are the
    serial ones. The fork pool is held to serial in a child process
    (test_torch_port_serve.py); here the thread pool, where fork is
    missing, on a plain list."""
    monkeypatch.setattr(pipeline.multiprocessing, "get_all_start_methods",
                        lambda: ["spawn"])
    data, sampler = [f"item{i}" for i in range(5)], [[3, 0], [4, 1], [2]]
    want = list(pipeline.batch_iterator(data, sampler, tuple))
    assert want == [("item3", "item0"), ("item4", "item1"), ("item2",)]
    assert list(pipeline.batch_iterator(data, sampler, tuple, num_workers=2)) == want


def _spec():
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    return ModelSpec.from_config(Config(opt), BertConfig.tiny())


def test_put_moves_aliases_once_and_checks_indices():
    spec = _spec()
    grid = np.ones((2, 3), np.int16)
    block = {"glove": grid, "fasttext": grid, "num": np.array([3, 2], np.int32),
             "position": np.zeros((2, 3, 8), np.float32)}
    gt = np.zeros((2, 4), np.float32)
    host = pipeline.host_batch((block, block, block, gt, ["meta"]), spec, slim=False)
    q = host[0]
    assert q["glove"] is q["fasttext"]                 # one tensor for both
    dev = pipeline.device_put_batch(host, torch.device("cpu"))
    assert dev[0]["glove"] is dev[0]["fasttext"]
    assert dev[4] == ["meta"] and torch.equal(dev[3], torch.from_numpy(gt))
    bad = dict(block, glove=np.full((2, 3), spec.vocab_size, np.int16))
    with pytest.raises(ValueError, match="glove"):
        pipeline.host_block(bad, spec, slim=False)


def test_average_meter_round_trip():
    m = AverageMeter()
    for v in (1.0, 2.0, 6.0):
        m.update(v)
    assert (m.avg, m.count, m.val) == (3.0, 3, 6.0)
    m2 = AverageMeter()
    m2.load_state_dict(m.state_dict())
    assert m2.state_dict() == m.state_dict()


def test_debug_nans_checks_name_their_site():
    ok = {"position": torch.zeros(2, 3)}
    targets = torch.zeros(2, 4)
    _check_inputs(ok, ok, ok, targets)
    with pytest.raises(FloatingPointError, match="NaN/Inf in batch input ocr.position"):
        _check_inputs(ok, {"position": torch.tensor([float("nan")])}, ok, targets)
    with pytest.raises(FloatingPointError, match="NaN/Inf in targets"):
        _check_inputs(ok, ok, ok, torch.tensor([float("inf")]))


@pytest.mark.parametrize("key,value", [
    ("coordinator_address", "localhost:1"), ("img_feature", ""),
    ("tensor_parallel", 2),
])
def test_trainer_refuses_unported_branches_by_name(key, value):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt[key] = value
    if key == "img_feature":
        # ported: as the JAX trainer, it loads the features when it is
        # built; without img_fea_folder that is the HDF5 pack beside the
        # feature folder, missing here
        opt["FEATURE_FOLDER"] = "no/such/folder/"
        with pytest.raises((FileNotFoundError, ImportError),
                           match="train36_imgid2idx.pkl|h5py"):
            Trainer(Config(opt), device="cpu")
        return
    # mesh execution is ported: with coordinator_address the trainer joins
    # a torch.distributed world (here of one rank, on a free port); one
    # rank has no mesh whatever tensor_parallel asks, as one JAX device
    # has none
    import torch.distributed as dist

    from ruart_tpu_torch.parallel.distributed import free_port

    if key == "coordinator_address":
        opt[key] = f"localhost:{free_port()}"
    try:
        trainer = Trainer(Config(opt), device="cpu")
        assert dist.is_initialized() == (key == "coordinator_address")
        trainer.setup_model({})
        assert trainer.mesh is None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_import_scan_covers_the_training_slice():
    """tests/test_torch_port_imports.py scans every module of the port; the
    modules this slice added are among them."""
    import test_torch_port_imports as scan

    names = {p.relative_to(scan.REPO).as_posix() for p in scan.SOURCES}
    for sub in ("train/trainer.py", "train/optim.py", "train/train_step.py",
                "train/checkpoint.py", "train/loss.py", "eval/evaluator.py",
                "cli/main.py", "cli/main_test.py", "utils/meters.py",
                "data/pipeline.py", "data/sampler.py"):
        assert f"ruart_tpu_torch/{sub}" in names
