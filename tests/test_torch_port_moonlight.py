"""The Moonlight encoder (``models/moonlight``, ``ops/moe.py``, the
192/128 attention) against its plain float32 reference
(``portbench/reference/moonlight.py``) at a tiny size on the CPU: hidden
64, 4 heads of 16 + 8 (rope) with values of 16, kv_lora 32, 8 experts of
32 with top 2 and one shared, 3 layers, the first dense; seeded weights
and a nonzero correction bias.

Tolerances: the port and the reference compute the same float32
operations in another order (the reference's experts as slots summed
after the loop, the port's through the permuted twin), so layer outputs
agree to 1e-5 of their scale and the loss to 1e-5 relative; the gradients
to 1e-5 of the largest. Routing is compared exactly: no two choice values
of these weights lie within float32 round-off of each other.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench.reference import moonlight as ref
from ruart_tpu_torch.core.config import Config, read_conf_lines
from ruart_tpu_torch.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.models.moonlight import MoonlightConfig, MoonlightModel
from ruart_tpu_torch.models.moonlight.model import causal_segment_bias
from ruart_tpu_torch.ops import attention as att
from ruart_tpu_torch.ops import moe
from ruart_tpu_torch.parallel.mesh import Mesh
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from ruart_tpu_torch.train.loss import make_loss_fn

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = len(build_demo_vocab())
TINY = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, n_routed_experts=8, n_shared_experts=1,
            num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)


def seeded(model, seed=3):
    """N(0, 0.1) for every matrix (larger than the cell's 0.02, so that
    the tiny layers' outputs are far from round-off), the norms near 1,
    the correction bias N(0, 0.05)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith("norm"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("e_score_correction_bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def pair():
    port = seeded(MoonlightModel(MoonlightConfig(**TINY)))
    plain = ref.MoonlightEncoder(ref.MoonlightConfig(**TINY))
    plain.load_state_dict(port.state_dict(), strict=False)
    return port, plain


def packed_rows(seed=0):
    """Two packed rows of 12 tokens: segments of 5, 4 (then 3 pads) and 7,
    5; positions restart in each segment."""
    rng = np.random.default_rng(seed)
    ids = torch.zeros(2, 12, dtype=torch.long)
    seg = torch.zeros(2, 12, dtype=torch.long)
    pos = torch.zeros(2, 12, dtype=torch.long)
    for r, lens in enumerate(((5, 4), (7, 5))):
        at = 0
        for s, n in enumerate(lens, 1):
            ids[r, at:at + n] = torch.as_tensor(rng.integers(1, VOCAB, n))
            seg[r, at:at + n] = s
            pos[r, at:at + n] = torch.arange(n)
            at += n
    return ids, seg, pos


def test_layers_match_the_reference(pair):
    port, plain = pair
    ids, seg, pos = packed_rows()
    got, _ = port(ids, segment_ids=seg, position_ids=pos)
    want, _ = plain(ids, segment_ids=seg, position_ids=pos)
    assert got.shape == want.shape == (3, 2, 12, 64)
    real = seg > 0
    for layer in range(3):
        a, b = got[layer][real], want[layer][real]
        assert (a - b).abs().max() <= TOL * b.abs().max(), layer


def test_routing_matches_the_reference(pair):
    port, plain = pair
    ids, seg, pos = packed_rows(1)
    port.routes, plain.routes = [], []
    try:
        port(ids, segment_ids=seg, position_ids=pos)
        plain(ids, segment_ids=seg, position_ids=pos)
        assert len(port.routes) == len(plain.routes) == 2
        for a, b in zip(port.routes, plain.routes):
            assert torch.equal(a.sort(-1).values.long(),
                               b.sort(-1).values.long())
    finally:
        port.routes = plain.routes = None
    # the weights: s_sel / sum * scale, over the experts the bias chose
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(40, 8, generator=g)
    bias = 0.3 * torch.randn(8, generator=g)
    idx, w, counts = moe.route(logits, bias, 2, 2.446)
    s = torch.sigmoid(logits)
    want_idx = torch.topk(s + bias, 2).indices
    assert torch.equal(idx.long(), want_idx)
    sel = s.gather(1, want_idx)
    assert torch.allclose(w, sel / sel.sum(-1, keepdim=True) * 2.446,
                          rtol=1e-6)
    assert not torch.equal(want_idx, torch.topk(s, 2).indices)
    assert counts.sum() == 80 and torch.equal(
        counts.long(), torch.bincount(want_idx.reshape(-1), minlength=8))


def test_packed_row_equals_its_segments_alone(pair):
    port, _ = pair
    ids, seg, pos = packed_rows(2)
    packed, _ = port(ids, segment_ids=seg, position_ids=pos)
    for r in range(2):
        for s in (1, 2):
            cols = (seg[r] == s).nonzero().squeeze(1)
            alone, _ = port(ids[r:r + 1, cols])
            diff = (packed[:, r, cols] - alone[:, 0]).abs().max()
            assert diff <= TOL * alone.abs().max(), (r, s)
    # causal: a segment's first token does not see the rest of it
    bias = causal_segment_bias(seg)
    assert bias[0, 0, 1] < 0 and bias[0, 1, 0] == 0 and bias[0, 5, 4] < 0


def test_grouped_gemm_twin_equals_a_loop_over_tokens():
    g = torch.Generator().manual_seed(11)
    T, D, W, E, k = 30, 16, 8, 5, 2
    x = torch.randn(T, D, generator=g)
    logits = torch.randn(T, E, generator=g)
    bias = torch.zeros(E)
    bias[3] = 5.0  # every token takes expert 3; expert 4 gets none below
    logits[:, 4] = -50.0
    w_gu = torch.randn(E, 2 * W, D, generator=g)
    w_d = torch.randn(E, D, W, generator=g)
    shared = torch.randn(T, D, generator=g)
    res = torch.randn(T, D, generator=g)
    load = torch.zeros(E, dtype=torch.int64)
    out, idx = moe.experts(x, logits, bias, k, 1.5, w_gu, w_d, shared, res,
                           load)
    _, w, counts = moe.route_plain(logits, bias, k, 1.5)
    assert counts[3] == T and counts[4] == 0 and torch.equal(load, counts.long())
    want = res + shared
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j])
            h = w_gu[e] @ x[t]
            y = w_d[e] @ (torch.nn.functional.silu(h[:W]) * h[W:])
            want[t] += w[t, j] * y
    assert (out - want).abs().max() <= TOL * want.abs().max()
    offsets, rows, slot_pos = moe.permute(idx, counts)
    assert offsets.tolist() == [0] + torch.cumsum(counts, 0).tolist()
    assert torch.equal(rows[slot_pos.long()].long(),
                       torch.arange(T).repeat_interleave(k))


def test_attention_takes_a_narrower_value_and_a_scale():
    g = torch.Generator().manual_seed(2)
    q, k = (torch.randn(3, 7, 4 * 24, generator=g) for _ in range(2))
    v = torch.randn(3, 7, 4 * 16, generator=g)
    bias = causal_segment_bias(torch.ones(3, 7, dtype=torch.long))
    out = att.fused_attention(q, k, v, bias, 4, scale=0.125)
    assert out.shape == (3, 7, 64)
    qh, kh, vh = (t.reshape(3, 7, 4, -1) for t in (q, k, v))
    p = torch.softmax(torch.einsum("blhd,bmhd->bhlm", qh, kh) * 0.125
                      + bias[:, None], -1)
    want = torch.einsum("bhlm,bmhd->blhd", p, vh).reshape(3, 7, 64)
    assert torch.allclose(out, want, atol=1e-6)
    assert torch.equal(att.attention_rows_plain(q, k, q, bias, 4),
                       att.attention_rows_plain(q, k, q, bias, 4, scale=None))


def _opt(tmp_path, **extra):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dict(TINY, model_type="deepseek_v3")))
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    opt.update({"batch_size": 2, "preprocess_ocr_name": "ocr_PMTD_ASTER,ES_ocr",
                "preprocess_od_name": "OD_bottom-up", "datadir": ".",
                "FEATURE_FOLDER": ".", "LLM_ENCODER": str(path)})
    for key in ("DROPOUT", "dropout_emb"):
        opt.pop(key)
    opt.update(extra)
    return opt


def _batch(opt):
    cfg = Config(opt)
    pre = Preprocessor(cfg)
    raw = make_synthetic_raw_dataset(2, seed=5, n_ocr_range=(3, 9), n_es=6)
    data = pre._process_data(raw["data"])
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    ds = VQADataset(data, cfg, mode="train",
                    tokenizer=WordPieceTokenizer(build_demo_vocab()))
    return cfg, Collator(cfg)([ds[i] for i in range(len(ds))])


def test_train_step_matches_the_reference(tmp_path):
    from portbench.reference.spec import ModelSpec as RefSpec

    cfg, batch = _batch(_opt(tmp_path))
    assert cfg.dims.bert_dim == 64 and cfg.dims.bert_layers == 3
    spec = ModelSpec.from_config(cfg)
    assert isinstance(spec.bert, MoonlightConfig)
    port = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    seeded(port.Bert)
    assert not any(p.requires_grad for p in port.Bert.parameters())
    ref_spec = dataclasses.replace(RefSpec(**{
        f.name: getattr(spec, f.name) for f in dataclasses.fields(RefSpec)
        if f.name != "bert"}, bert=ref.MoonlightConfig(**TINY)))
    plain = ref.ruart_model(ref_spec)
    plain.load_state_dict(port.state_dict())
    loss_fn = make_loss_fn("BCE_D1")
    results = []
    for model in (port, plain):
        q, ocr, od = ({k: torch.as_tensor(np.ascontiguousarray(v))
                       for k, v in b.items()} for b in batch[:3])
        gt = torch.as_tensor(batch[3])
        model.train()
        model.zero_grad()
        loss = loss_fn(model(q, ocr, od), gt)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        results.append((float(loss.detach()), grads))
    (lp, gp), (lr, gr) = results
    assert abs(lp - lr) <= TOL * abs(lr)
    assert sorted(gp) == sorted(gr) and "alphaBERT" in gp
    assert not any(n.startswith("Bert.") for n in gp)
    top = max(g.abs().max() for g in gr.values())
    for n in gp:
        assert (gp[n] - gr[n]).abs().max() <= TOL * top, n


@pytest.mark.parametrize("conflict", ["BERT_LARGE", "INT8_BERT", "mesh",
                                      "max_ocr_bert_len", "bert_pack_len"])
def test_refusals_name_the_conflict(tmp_path, conflict):
    if conflict == "mesh":
        spec = ModelSpec.from_config(Config(_opt(tmp_path)))
        with pytest.raises(ValueError, match="mesh"):
            RUArtModel(spec, Mesh.local(1, 2, 0, 0))
        return
    extra = {conflict: 513} if conflict.startswith(("max_", "bert_")) else {
        conflict: True}
    with pytest.raises(ValueError, match=conflict):
        ModelSpec.from_config(Config(_opt(tmp_path, **extra)))


def test_rows_over_512_are_refused_by_the_encoder():
    model = MoonlightModel(MoonlightConfig(**TINY))
    with pytest.raises(ValueError, match="512"):
        model(torch.ones(1, 513, dtype=torch.long))


def test_train_step_and_evaluate_run_the_encoder(tmp_path):
    """The trainer's step (``make_train_step`` with the optimizer) and
    ``evaluate`` over RUArt with the tiny Moonlight encoder: the encoder's
    weights stay out of the optimizer and unchanged, the combine weights
    move, the scores are finite."""
    import math

    from ruart_tpu_torch.eval.evaluator import evaluate
    from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
    from ruart_tpu_torch.train.train_step import (
        init_train_state, make_eval_step, make_train_step)

    opt = _opt(tmp_path)
    cfg, batch = _batch(opt)
    spec = ModelSpec.from_config(cfg)
    model = RUArtModel(spec).init_weights(torch.Generator().manual_seed(1))
    optimizer = Optimizer("#", 1e-3, 10.0, model, spec, True)
    assert not any(n.startswith("Bert.") for n in optimizer.params)
    before = {n: p.clone() for n, p in model.named_parameters()}
    step = make_train_step(make_loss_fn("BCE_D1"),
                           make_row_pinner(model, spec, 1000))
    state = init_train_state(model, optimizer, cfg.seed)
    q, ocr, od = ({k: torch.as_tensor(np.ascontiguousarray(v))
                   for k, v in b.items()} for b in batch[:3])
    state, loss = step(state, q, ocr, od, torch.as_tensor(batch[3]))
    assert math.isfinite(float(loss))
    after = dict(model.named_parameters())
    assert all(torch.equal(after[n], before[n]) for n in before
               if n.startswith("Bert."))
    assert not torch.equal(after["alphaBERT"], before["alphaBERT"])

    pre = Preprocessor(cfg)
    raw = make_synthetic_raw_dataset(3, seed=6, n_ocr_range=(3, 9), n_es=6)
    data = pre._process_data(raw["data"])
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    ds = VQADataset(data, cfg, mode="dev",
                    tokenizer=WordPieceTokenizer(build_demo_vocab()))
    out = evaluate(make_eval_step(model, make_loss_fn("BCE_D1")), ds, cfg,
                   spec, torch.device("cpu"))
    assert out["n"] == 3 and math.isfinite(out["loss"])
    assert all(math.isfinite(r["score"]) for r in out["save_res"])
