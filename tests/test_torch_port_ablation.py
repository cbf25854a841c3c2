"""tools/torch_attention_ablation.py builds each of its variants of the bf16
attention kernel by text patches of ruart_tpu_torch/csrc/attention_bf16.cu:
each patch must match the source as it is, exactly once, and change it."""

import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "torch_attention_ablation", REPO / "tools" / "torch_attention_ablation.py")
ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ablation)
SOURCE = (REPO / "ruart_tpu_torch" / "csrc" / ablation.BF16_SOURCE).read_text()


@pytest.mark.parametrize("name", sorted(ablation.PATCHES))
def test_variant_applies_to_the_source(name):
    text = ablation.patched(SOURCE, name)
    assert text != SOURCE
    for old, new in ablation.PATCHES[name]:
        assert new in text


def test_a_stale_patch_is_refused():
    with pytest.raises(SystemExit, match="does not apply"):
        ablation.patched(SOURCE.replace("kKeyTile = 64", "kKeyTile = 48"),
                         "ktile32")
