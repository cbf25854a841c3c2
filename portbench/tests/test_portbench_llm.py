"""The Moonlight cell (``drivers/train_llm.py``) at a tiny size on the
CPU (``harness.local``, the cell's own limits): the result line holds the
cell's end-to-end and per-layer metrics, the program and the reference
draw identical encoder weights, and a planted fault (top 5 of the experts
in the program's place) comes out not correct."""

import copy

import pytest
import torch

from portbench import build, harness, llm
from portbench.tests import tiny

CELL = "moonlight-bf16.train-b16-llm"
# the encoder cut to the port's tiny test sizes (hidden 64, 4 heads of
# 16 + 8 rope and 16 values, kv_lora 32, 8 experts of 32, top 2 and one
# shared, 3 layers, the first dense)
TINY_ENCODER = dict(vocab_size=30522, hidden_size=64, intermediate_size=96,
                    moe_intermediate_size=32, num_hidden_layers=3,
                    num_attention_heads=4, n_routed_experts=8,
                    n_shared_experts=1, num_experts_per_tok=2,
                    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                    v_head_dim=16)


def tiny_config():
    c = copy.deepcopy(build.read_json("configs", "moonlight-bf16"))
    c["conf"] = dict(tiny.TINY_CONF, **{k: v for k, v in c["conf"].items()
                                        if k not in tiny.TINY_CONF})
    c["bert"].update(TINY_ENCODER)
    return c


def test_published_keys_are_the_encoder_block():
    c = build.read_json("configs", "moonlight-bf16")
    assert c["bert"]["model_type"] == "deepseek_v3"
    assert all(c[k] == v for k, v in c["bert"].items())
    assert (c["hidden_size"], c["num_hidden_layers"], c["n_routed_experts"],
            c["num_experts_per_tok"], c["vocab_size"]) == (
                2048, 27, 64, 6, 163840)


def run(control=None, trace=False, seed=2147483677):
    return harness.local(CELL, seed, 0.3, config=tiny_config(),
                         traffic=tiny.traffic("train-b16-llm", **tiny.TRAIN),
                         control=control, trace=trace)


def test_result_line_and_sound_run():
    line, out = run()
    assert line["correct"], line["compared"]
    bench = harness.benchmark()
    per_layer = [m["name"] for m in bench["per_layer"]
                 if harness.applies(m, CELL)]
    assert sorted(per_layer) == sorted([
        "step_mfu.train-llm", "moe_gemm_roofline.train-llm",
        "mla_roofline.train-llm", "moe_route_pct.train-llm",
        "graph_captures.train-llm", "device_idle_pct.train-llm",
        "collate_ms.train-llm"])
    assert set(line["metrics"]) == {"train_questions_per_s", "setup_s"}
    assert line["compared"]["train.checked_captures"]["value"] == 0
    assert "train.encoder" in line["compared"]
    # the per-layer readers read the record without raising; on the CPU
    # only the capture count has something to read (no device trace, no
    # spans outside a traced run)
    for name in per_layer:
        value = harness.reader(name)(out.record)
        assert value is None or name.startswith("graph_captures"), name
    assert harness.reader("graph_captures.train-llm")(out.record) == 0


def test_program_and_reference_draw_identical_weights():
    from portbench.reference.moonlight import MoonlightConfig as RefConfig
    from portbench.reference.moonlight import MoonlightEncoder
    from ruart_tpu_torch.models.moonlight import MoonlightConfig, MoonlightModel

    for dtype in (torch.float32, torch.bfloat16):
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        prog = llm.draw_encoder(MoonlightModel(
            MoonlightConfig(**TINY_ENCODER, dtype=name)), 7)
        ref = llm.draw_encoder(MoonlightEncoder(
            RefConfig(**TINY_ENCODER), dtype), 7)
        p, r = dict(prog.named_parameters()), dict(ref.named_parameters())
        assert sorted(p) == sorted(r)
        for k in p:
            assert p[k].dtype == r[k].dtype == dtype
            assert torch.equal(p[k], r[k]), k
        bias = p["layer_1.mlp.e_score_correction_bias"]
        assert bias.abs().min() > 0 and bias.std() > 0.01
        assert not torch.equal(p["layer_1.mlp.gate"][0], p["layer_1.mlp.gate"][1])


@pytest.mark.parametrize("fault", ["top5"])
def test_fault_is_not_correct(fault):
    line, _ = run(control=fault)
    assert not line["correct"], line["compared"]


def test_traced_run_reads_the_host_pipeline_and_device_idle():
    line, out = run(trace=True)
    assert line["correct"], line["compared"]
    collate = harness.reader("collate_ms.train-llm")(out.record)
    idle = harness.reader("device_idle_pct.train-llm")(out.record)
    assert collate is not None and collate > 0
    assert idle is not None and 0 <= idle <= 100
    assert line["metrics"]["collate_ms.train-llm"]["value"] == collate
