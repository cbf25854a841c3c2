"""The weight bridge (ruart_tpu_torch/convert.py) and the port's model
construction: a flax RUArtModel random init maps onto the port's state
dict key for key, shape for shape and value for value, and every conf
branch builds (PHOC included)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.core.presets import tiny_config
from ruart_tpu.data.synthetic import make_synthetic_batch
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu.train.checkpoint import flatten_tree
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.core.presets import tiny_config as port_tiny_config
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel, unported_conf_keys
from ruart_tpu_torch.models.fusion.spec import ModelSpec

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def flax_params():
    cfg = tiny_config(batch_size=2)
    spec = JaxModelSpec.from_config(cfg, JaxBertConfig.tiny())
    q, ocr, od, _ = make_synthetic_batch(spec, cfg, 2, seed=0)
    params = jax.jit(JaxRUArtModel(spec).init)(
        jax.random.PRNGKey(0),
        *(jax.tree.map(jnp.asarray, t) for t in (q, ocr, od)),
    )
    return jax.tree.map(np.asarray, params)


def _port_spec(**opt):
    return ModelSpec.from_config(port_tiny_config(batch_size=2, **opt),
                                 BertConfig.tiny())


def test_state_dict_covers_every_param(flax_params):
    sd = from_jax_params(flax_params)
    model = RUArtModel(_port_spec())
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for key, value in sd.items():
        assert value.shape == want[key].shape, key
    model.load_state_dict(sd)  # strict


def test_values_are_exact(flax_params):
    """Every flax leaf lands in the state dict unchanged (kernels
    transposed), and the LSTM gates keep their order."""
    sd = from_jax_params(flax_params)
    flat = flatten_tree(flax_params["params"])
    assert len(flat) == len(sd)
    renames = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
               "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0"}
    for path, value in flat.items():
        parts = path.split("/")
        leaf = parts.pop()
        if leaf in renames:
            direction = parts.pop()
            key = ".".join(parts + [renames[leaf] + (
                "_reverse" if direction == "bwd" else "")])
        else:
            name = {"kernel": "weight", "embedding": "weight",
                    "scale": "weight"}.get(leaf, leaf)
            key = ".".join(parts + [name])
            if leaf == "kernel":
                value = value.T
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


def test_random_init_is_seeded():
    a = RUArtModel(_port_spec()).init_weights(torch.Generator().manual_seed(5))
    b = RUArtModel(_port_spec()).init_weights(torch.Generator().manual_seed(5))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    w = a.state_dict()["Bert.layer_0.attention_self.query.weight"]
    assert 0.01 < w.std().item() < 0.03  # N(0, initializer_range)


@pytest.mark.parametrize("key,value", [
    ("fixed_answers", True), ("img_feature", True),
    ("no_DeepAttention", True), ("PRE_ALIGN_after_rnn", True),
    ("ES_using_way", "post_process"), ("position_mod", "cat"),
])
def test_unported_conf_branches_raise(key, value):
    """These branches are ported now and build, with PHOC as well: no conf
    key is left unported."""
    spec = _port_spec(**{key: value})
    assert unported_conf_keys(spec) == []
    RUArtModel(spec)
    spec = _port_spec(PHOC=True, **{key: value})
    assert unported_conf_keys(spec) == []
    assert RUArtModel(spec).phoc_embed.weight.shape == (spec.vocab_size, 604)


@pytest.mark.parametrize("key", ["BF16", "INT8_BERT"])
def test_reduced_precision_conf_keys_raise(key):
    """Both are ported: BF16 selects the bf16 encoder, INT8_BERT the
    weight-only int8 one; neither raises."""
    if key == "INT8_BERT":
        assert _port_spec(INT8_BERT=True).bert.quant == "int8"
        assert _port_spec().bert.quant == "none"
        return
    assert _port_spec(BF16=True).bert.dtype == "bfloat16"
    assert _port_spec().bert.dtype == "float32"


def test_attention_impl_is_checked():
    assert dataclasses.replace(BertConfig(), attention_impl="plain")
    with pytest.raises(ValueError, match="attention_impl"):
        BertConfig(attention_impl="pallas")
