"""Checkpoints both ways between the JAX package and the port
(ruart_tpu_torch/train/checkpoint.py, convert.to_jax_params):

* ``to_jax_params`` of a port model has exactly the paths and shapes of a
  flax init of the same spec (``jax.eval_shape``, no compile), and
  inverts ``from_jax_params``;
* a checkpoint written by ``ruart_tpu.train.checkpoint.save_checkpoint``
  loads into the port, and one the port writes loads into
  ``ruart_tpu.train.checkpoint.load_checkpoint``: equal arrays both ways;
* key intersection: stored keys the model lacks and stored arrays of
  another shape are dropped, the rest load;
* ``save_for_predict`` drops the ``Bert`` subtree;
* optimizer state: the port's resumes in the port; a checkpoint without
  one restarts the moments; the JAX package's optimizer leaves or a
  mismatch raise unless LENIENT (strict=False).
"""

import jax
import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.data.synthetic import make_synthetic_batch
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu.train import checkpoint as jax_ckpt
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.config import Config, read_conf_lines
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.train import checkpoint as ckpt
from ruart_tpu_torch.train.optim import Optimizer

torch.set_num_threads(2)


def _opt():
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({"batch_size": 2})
    return opt


def _port_model(seed=0):
    spec = ModelSpec.from_config(Config(_opt()), BertConfig.tiny(vocab_size=120))
    return RUArtModel(spec).init_weights(torch.Generator().manual_seed(seed)), spec


def _flat(tree):
    return jax_ckpt.flatten_tree(tree)


@pytest.fixture(scope="module")
def flax_shapes():
    cfg = JaxConfig(_opt())
    spec = JaxModelSpec.from_config(cfg, JaxBertConfig.tiny(vocab_size=120))
    q, ocr, od, _ = make_synthetic_batch(spec, cfg, 2, seed=0)
    shapes = jax.eval_shape(JaxRUArtModel(spec).init, jax.random.PRNGKey(0),
                            q, ocr, od)
    tree = jax.tree.map(lambda s: np.empty(s.shape, s.dtype), shapes)
    return {k: v.shape for k, v in _flat(tree).items()}


def test_to_jax_params_has_the_flax_tree(flax_shapes):
    model, _ = _port_model()
    ours = {k: v.shape for k, v in _flat(to_jax_params(model)).items()}
    assert ours == flax_shapes
    back = from_jax_params(to_jax_params(model))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    src, _ = _port_model(seed=1)
    flax_params = to_jax_params(src)
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, flax_params, None, {"updates": 7})
    dst, _ = _port_model(seed=2)
    opt_arrays, jax_opt, meta = ckpt.load_checkpoint(path, dst)
    assert opt_arrays is None and not jax_opt and meta == {"updates": 7}
    for name, t in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[name], t, rtol=0, atol=0)


def test_port_checkpoint_loads_into_jax(tmp_path):
    model, spec = _port_model(seed=3)
    opt = Optimizer("#", 1e-3, 10.0, model, spec, True)
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, model, opt, {"updates": 3})
    init = jax.tree.map(np.zeros_like, to_jax_params(_port_model(seed=4)[0]))
    params, opt_leaves, meta = jax_ckpt.load_checkpoint(path, init)
    assert opt_leaves is None and meta == {"updates": 3}  # port keys ignored
    want = _flat(to_jax_params(model))
    got = _flat(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_key_intersection_and_shape_mismatch(tmp_path):
    src, _ = _port_model(seed=5)
    tree = to_jax_params(src)
    tree["params"]["not_a_module"] = {"kernel": np.ones((2, 2), np.float32)}
    gamma = tree["params"]["gammaBERT"]
    tree["params"]["gammaBERT"] = np.ones((3, 3), np.float32)  # wrong shape
    del tree["params"]["alphaBERT"]                            # missing
    path = str(tmp_path / "partial.ckpt")
    jax_ckpt.save_checkpoint(path, tree, None, {})
    dst, _ = _port_model(seed=6)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    ckpt.load_checkpoint(path, dst)
    after = dst.state_dict()
    torch.testing.assert_close(after["gammaBERT"], before["gammaBERT"])
    torch.testing.assert_close(after["alphaBERT"], before["alphaBERT"])
    assert gamma.shape == (1, 1)
    for name, t in src.state_dict().items():
        if name not in ("gammaBERT", "alphaBERT"):
            torch.testing.assert_close(after[name], t, rtol=0, atol=0)


def test_save_for_predict_drops_bert(tmp_path):
    model, _ = _port_model()
    path = str(tmp_path / "predict.ckpt")
    ckpt.save_for_predict(path, model, {"updates": 1})
    with np.load(path) as z:
        keys = set(z.files)
    assert not any(k.startswith("params/params/Bert/") for k in keys)
    assert {"params/params/alphaBERT", "params/params/glove_embed/embedding"} <= keys


def test_optimizer_state_resume_rules(tmp_path):
    model, spec = _port_model(seed=7)
    opt = Optimizer("#", 1e-3, 10.0, model, spec, True)
    for p in opt.params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    full = str(tmp_path / "full.ckpt")
    ckpt.save_checkpoint(full, model, opt, {})
    fresh = Optimizer("#", 1e-3, 10.0, model, spec, True)
    arrays, jax_opt, _ = ckpt.load_checkpoint(full, model)
    ckpt.restore_optimizer(fresh, arrays, jax_opt)
    assert fresh.count == 1
    for name, st in opt.state.items():
        torch.testing.assert_close(fresh.state[name]["mu"], st["mu"])
    # another optimizer's state: strict raises, lenient restarts
    other = Optimizer("ADAM2", 1e-3, 10.0, model, spec, False)
    with pytest.raises(ValueError, match="LENIENT_OPT_RESUME"):
        ckpt.restore_optimizer(other, arrays, jax_opt)
    ckpt.restore_optimizer(other, arrays, jax_opt, strict=False)
    assert other.count == 0
    # the JAX package's optimizer leaves mean nothing to the port
    jax_full = str(tmp_path / "jax_full.ckpt")
    jax_ckpt.save_checkpoint(jax_full, to_jax_params(model),
                             [np.zeros(3, np.float32)], {})
    arrays, jax_opt, _ = ckpt.load_checkpoint(jax_full, model)
    assert arrays is None and jax_opt
    with pytest.raises(ValueError, match="JAX package"):
        ckpt.restore_optimizer(fresh, arrays, jax_opt)
    ckpt.restore_optimizer(fresh, arrays, jax_opt, strict=False)
    # a save_for_predict checkpoint has no optimizer state: fresh moments
    pred = str(tmp_path / "pred.ckpt")
    ckpt.save_for_predict(pred, model)
    arrays, jax_opt, _ = ckpt.load_checkpoint(pred, model)
    ckpt.restore_optimizer(fresh, arrays, jax_opt)


@pytest.mark.parametrize("prefix,ln", [("bert.", ("gamma", "beta")), ("", ("weight", "bias"))],
                         ids=["2018-gamma-beta", "hf-weight-bias"])
def test_pretrained_bert_mapping_matches_jax(prefix, ln):
    """A pretrained torch BERT state dict maps onto the port's ``Bert.``
    entries as ``ruart_tpu/models/bert/convert.py`` maps it onto flax."""
    from ruart_tpu.models.bert.convert import convert_bert_state_dict
    from ruart_tpu_torch.convert import bert_state_from_torch

    model, _ = _port_model()
    c = model.spec.bert
    rng = np.random.RandomState(0)
    state = {}

    def add(name, *shape):
        state[prefix + name] = torch.from_numpy(rng.randn(*shape).astype(np.float32))

    D, inner = c.hidden_size, c.intermediate_size
    for emb, n in (("word", c.vocab_size), ("position", c.max_position_embeddings),
                   ("token_type", c.type_vocab_size)):
        add(f"embeddings.{emb}_embeddings.weight", n, D)
    norms = ["embeddings.LayerNorm"]
    dense = {"pooler.dense": (D, D)}
    for i in range(c.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            dense[p + "attention.self." + name] = (D, D)
        dense[p + "attention.output.dense"] = (D, D)
        dense[p + "intermediate.dense"] = (inner, D)
        dense[p + "output.dense"] = (D, inner)
        norms += [p + "attention.output.LayerNorm", p + "output.LayerNorm"]
    for name, (o, i_) in dense.items():
        add(name + ".weight", o, i_)
        add(name + ".bias", o)
    for name in norms:
        add(f"{name}.{ln[0]}", D)
        add(f"{name}.{ln[1]}", D)
    want = from_jax_params({"Bert": convert_bert_state_dict(state, c.num_hidden_layers)})
    got = bert_state_from_torch(state, c.num_hidden_layers)
    assert set(got) == set(want) == {k for k in model.state_dict() if k.startswith("Bert.")}
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    model.load_state_dict(got, strict=False)
