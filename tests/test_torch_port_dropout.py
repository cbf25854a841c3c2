"""Dropout in the port (ruart_tpu_torch/models/fusion/layers.py and the
sites the model threads it to): the variational mask is shared over time,
the keep rate is near 1 - p at a fixed seed, masks come from the seeded
generator, and every dropout is the identity in eval mode. The JAX
package's random bits differ from torch's, so these are checks of
structure and rate, not of equal masks.
"""

import pytest
import torch

from ruart_tpu_torch.core.config import Config, read_conf_lines
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.layers import Dropper, seq_dropout
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab

torch.set_num_threads(2)
P = 0.3


def test_variational_mask_is_shared_over_time():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(64, 20, 50)
    y = seq_dropout(x, P, True, g)
    assert torch.equal(y, y[:, :1].expand_as(y))  # one [B, 1, D] mask
    kept = (y[:, 0] != 0).float().mean().item()
    assert abs(kept - (1 - P)) < 0.02
    vals = torch.unique(y)
    torch.testing.assert_close(vals, torch.tensor([0.0, 1 / (1 - P)]))


def test_plain_mask_per_element():
    g = torch.Generator().manual_seed(1)
    x = torch.ones(200, 300)   # 2-D: no time axis to share over
    y = seq_dropout(x, P, True, g)
    assert abs((y != 0).float().mean().item() - (1 - P)) < 0.01
    z = seq_dropout(torch.ones(8, 100, 40), P, False, g)  # variational off
    assert not torch.equal(z, z[:, :1].expand_as(z))


def test_dropper_eval_identity_and_needs_generator():
    d = Dropper(P)
    x = torch.randn(4, 5, 6)
    assert d.eval()(x) is x
    with pytest.raises(RuntimeError, match="seed_dropout"):
        d.train()(x)
    assert Dropper(0.0).train()(x) is x


def _model_and_batch():
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({"batch_size": 2, "preprocess_ocr_name": "ocr_PMTD_ASTER,ES_ocr",
                "preprocess_od_name": "OD_bottom-up"})
    cfg = Config(opt)
    pre = Preprocessor(cfg)
    data = pre._process_data(
        make_synthetic_raw_dataset(2, seed=5, n_ocr_range=(3, 9), n_es=6)["data"])
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    ds = VQADataset(data, cfg, mode="train",
                    tokenizer=WordPieceTokenizer(build_demo_vocab()))
    q, ocr, od, _, _ = Collator(cfg)([ds[i] for i in range(len(ds))])
    blocks = [{k: torch.from_numpy(v) for k, v in b.items()} for b in (q, ocr, od)]
    spec = ModelSpec.from_config(
        cfg, BertConfig.tiny(vocab_size=len(build_demo_vocab())))
    model = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    return model, blocks, spec


def test_model_dropout_sites_train_and_eval():
    model, blocks, spec = _model_and_batch()
    assert spec.dropout_p == 0.3 and spec.dropout_emb == 0.4 and spec.variational
    drops = [m for m in model.modules() if isinstance(m, Dropper)]
    assert {m.p for m in drops} == {0.3, 0.4}
    with torch.no_grad():
        model.eval()
        ref = model(*blocks)
        model.seed_dropout(7)
        assert all(m.generator is drops[0].generator for m in drops)
        assert torch.equal(model(*blocks), ref)   # eval: identity
        model.train()
        a = model(*blocks)
        model.seed_dropout(7)
        b = model(*blocks)
        c = model(*blocks)
    assert torch.isfinite(a).all()
    assert not torch.allclose(a, ref)             # training: dropout acts
    assert torch.equal(a, b)                      # same seed, same masks
    assert not torch.equal(b, c)                  # the stream moves on
    # no parameter or buffer was added by the dropout sites
    assert all("drop" not in k for k in model.state_dict())
