"""What the Moonlight cell adds to the benchmark's shared parts: its
weights drawn from the seed, the probe of the encoder's output on one
batch, and the record of the latent attention's calls.

Weights (:func:`draw_encoder`): the encoder is drawn per parameter in its
own type (bf16 on the card), in the order of the sorted names, from one
``torch.Generator`` on its device seeded from the run's seed: the
matrices and the embedding N(0, :data:`STD`), the router as a matrix
like the projections, ``e_score_correction_bias`` N(0, :data:`BIAS_STD`),
the norms 1. ``portbench.build.make_weights`` cannot make them (one fp32
buffer of every parameter would be 62 GB, and it fills a bare parameter
such as the router with 1.0, which ties every expert), so the fusion
model's weights come from it with the encoder set aside
(:func:`fusion_weights`). The program and the reference get identical
tensors, each drawing for itself.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from portbench import build

STD = 0.02        # the published config's initializer_range convention
BIAS_STD = 0.05   # the correction bias: a quarter of the scores' spread
STREAM = 0x5EED   # the encoder's generator: the seed plus this


@torch.no_grad()
def draw_encoder(encoder: torch.nn.Module, seed: int) -> torch.nn.Module:
    params = sorted(encoder.named_parameters())
    device = params[0][1].device
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) + STREAM) % (2 ** 63))
    for name, p in params:
        if name.endswith("norm"):
            p.fill_(1.0)
        elif name.endswith("e_score_correction_bias"):
            p.normal_(0.0, BIAS_STD, generator=gen)
        else:
            p.normal_(0.0, STD, generator=gen)
    return encoder


def fusion_weights(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``build.make_weights`` on every parameter of ``model`` but its
    encoder (``model.Bert``), which stays as it is and in its place."""
    mods = model._modules
    items = list(mods.items())
    mods.pop("Bert")
    try:
        build.make_weights(model, seed)
    finally:
        mods.clear()
        mods.update(items)
    return model


def conf_file(config: Dict[str, Any], folder: str) -> str:
    """The configuration's encoder (its ``bert`` block: the published
    config.json's keys) as a config.json in ``folder``, which the
    ``LLM_ENCODER`` conf key names."""
    import json
    import os

    path = os.path.join(folder, "encoder_config.json")
    with open(path, "w") as f:
        json.dump(config["bert"], f)
    return path


def encoder_calls(model, q, ocr, od) -> List[Dict[str, Any]]:
    """The encoder calls of one eval-mode forward of ``model`` (RUArt over
    the Moonlight encoder, program or reference) on a batch: per call its
    ids, segments and positions (on the device), as the model made them."""
    calls = []

    def grab(module, args, kwargs):
        ids = args[0]
        seg = kwargs.get("segment_ids")
        pos = kwargs.get("position_ids")
        calls.append({
            "ids": ids,
            "seg": (ids != 0).long() if seg is None else seg,
            "pos": (torch.arange(ids.shape[1], device=ids.device)[None]
                    .expand_as(ids) if pos is None else pos)})

    hook = model.Bert.register_forward_pre_hook(grab, with_kwargs=True)
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(q, ocr, od)
    finally:
        hook.remove()
        model.train(was)
    return calls


@torch.no_grad()
def program_outputs(encoder, call) -> torch.Tensor:
    """The program's encoder on one call's rows: every layer's output
    [n, R, L, D], as the forward RUArt calls gives them, held in bf16 (the
    values are bf16 before they are widened)."""
    out, _ = encoder(call["ids"], segment_ids=call["seg"],
                     position_ids=call["pos"], stop_layer_gradients=True)
    return out.to(torch.bfloat16)


@torch.no_grad()
def program_blocks(encoder, call) -> List[Dict[str, Any]]:
    """The program's encoder on one call's rows block by block, through its
    own modules (the layer's attention and FFN, its norms): per layer the
    input, the attention's output, the FFN's input and output (an expert
    layer's with a zero residual: its routed sum plus the shared experts)
    and the chosen experts; then the last layer's output and its norm."""
    from ruart_tpu_torch.models.moonlight.model import (
        causal_segment_bias, rms_norm, rope_tables)

    c = encoder.config
    eps = c.rms_norm_eps
    bias = causal_segment_bias(call["seg"])
    cos, sin = rope_tables(call["pos"], c.qk_rope_head_dim, c.rope_theta,
                           encoder.dtype)
    x = torch.nn.functional.embedding(call["ids"], encoder.embed_tokens)
    blocks = []
    for i in range(c.num_hidden_layers):
        layer = getattr(encoder, f"layer_{i}")
        attn = layer.self_attn(rms_norm(x, layer.input_layernorm, eps), bias,
                               cos, sin)
        h = x + attn
        y = rms_norm(h, layer.post_attention_layernorm, eps)
        if layer.dense:
            ffn, idx = layer.mlp(y), None
        else:
            ffn, idx = layer.mlp(y, torch.zeros_like(h))
        blocks.append({"x": x, "attn": attn, "y": y, "ffn": ffn,
                       "idx": idx})
        x = h + ffn
    blocks.append({"x": x, "norm": rms_norm(x, encoder.norm, eps)})
    return blocks


@torch.no_grad()
def reference_blocks(encoder, call, fault) -> List[Dict[str, Any]]:
    """:func:`program_blocks` of the reference encoder with ``fault`` (a
    control or a planted fault in the program's place), free-running."""
    from portbench.reference import moonlight as ref

    c = encoder.config
    eps = c.rms_norm_eps
    mask = ref.segment_mask(call["seg"], causal=fault != "nocausal")
    x = torch.nn.functional.embedding(call["ids"], encoder.embed_tokens).float()
    blocks = []
    for i in range(c.num_hidden_layers):
        layer = getattr(encoder, f"layer_{i}")
        attn = layer.self_attn(ref.rms_norm(x, layer.input_layernorm, eps),
                               mask, call["pos"])
        h = x + attn
        y = ref.rms_norm(h, layer.post_attention_layernorm, eps)
        ffn, idx = (layer.mlp(y), None) if layer.dense else layer.mlp(y, fault)
        blocks.append({"x": x, "attn": attn, "y": y, "ffn": ffn, "idx": idx})
        x = h + ffn
    blocks.append({"x": x, "norm": ref.rms_norm(x, encoder.norm, eps)})
    return blocks


@torch.no_grad()
def check_blocks(encoder, call, blocks) -> Dict[str, float]:
    """Each block of the candidate (``blocks``: :func:`program_blocks` or
    :func:`reference_blocks`) against the reference ``encoder``'s same
    block on the candidate's own input to it (fp32): the attention on the
    layer's input, the FFN on the FFN's input (so the router sees the same
    rows), the final norm on the last layer's output. Per block the gap
    over the real tokens, ||candidate - reference|| / ||reference||; the
    worst over the blocks (``worst``), the attention's, the FFN's and the
    norm's worst, the share of the candidate's routes (token, slot) the
    reference did not choose, and the worst per-token gap of any block
    (``token``: ||candidate - reference|| / ||reference|| over one real
    token's width, what ``train.encoder`` holds)."""
    from portbench.reference import moonlight as ref

    c = encoder.config
    eps = c.rms_norm_eps
    real = call["seg"].reshape(-1) > 0
    mask = ref.segment_mask(call["seg"])
    out = {"attn": 0.0, "ffn": 0.0, "norm": 0.0, "token": 0.0}
    diff = total = 0

    def gap(cand, want, kind):
        a = cand.float().reshape(-1, cand.shape[-1])[real]
        b = want.float().reshape(-1, want.shape[-1])[real]
        d = (a - b).norm(dim=1)
        g = float(d.norm() / b.norm().clamp(min=1e-30))
        out[kind] = max(out[kind], g)
        out["token"] = max(out["token"], float(
            (d / b.norm(dim=1).clamp(min=1e-30)).max()))

    for i, blk in enumerate(blocks[:-1]):
        layer = getattr(encoder, f"layer_{i}")
        x = blk["x"].float()
        gap(blk["attn"], layer.self_attn(
            ref.rms_norm(x, layer.input_layernorm, eps), mask, call["pos"]),
            "attn")
        y = blk["y"].float()
        if layer.dense:
            gap(blk["ffn"], layer.mlp(y), "ffn")
            continue
        want, idx = layer.mlp(y)
        gap(blk["ffn"], want, "ffn")
        got = blk["idx"].reshape(-1, blk["idx"].shape[-1])[real].long()
        chosen = idx.reshape(-1, idx.shape[-1])[real]
        hit = (got[:, :, None] == chosen[:, None, :]).any(-1)
        diff += int((~hit).sum()) + abs(got.shape[1] - chosen.shape[1]) * int(
            real.sum())
        total += chosen.numel()
    last = blocks[-1]
    gap(last["norm"], ref.rms_norm(last["x"].float(), encoder.norm, eps),
        "norm")
    out["worst"] = max(out["attn"], out["ffn"], out["norm"])
    out["route_disagree"] = diff / total if total else 0.0
    return out


class Replay(torch.nn.Module):
    """In the reference RUArtModel's encoder slot: each call returns the
    α-combine (the reference model's own weights, in its own order of
    operations) of the layer outputs another encoder gave for the same
    rows, taken in call order (``outputs``: (ids, [n, R, L, D]) per call);
    raises on rows that are not the next call's."""

    def __init__(self, outputs):
        super().__init__()
        self.outputs = list(outputs)
        self.at = 0

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                combine_weights=None, segment_ids=None, position_ids=None,
                stop_layer_gradients=False):
        ids, layers = self.outputs[self.at]
        self.at += 1
        if not torch.equal(ids.long(), input_ids.long()):
            raise RuntimeError("the replayed encoder call has other rows")
        acc = None
        for i in range(layers.shape[0]):
            term = combine_weights[i] * layers[i].float()
            acc = term if acc is None else acc + term
        return acc, None


class MlaCalls:
    """The shapes of the latent attention's kernel calls (v narrower than
    q), per batch signature: a wrapper around
    ``ops.attention.attention_rows`` records them during the first call of
    each signature (its eager run, then its capture: the first half is the
    step's)."""

    def __init__(self):
        import ruart_tpu_torch.ops.attention as att

        self.att = att
        self.calls: List[tuple] = []
        self.by_signature: Dict[Any, List[tuple]] = {}
        self._orig = att.attention_rows

        def recorded(q, k, v, bias, heads, *args, **kw):
            if q.device.type == "cuda" and v.shape[-1] != q.shape[-1]:
                self.calls.append((q.shape[0], q.shape[1], heads,
                                   q.shape[2] // heads, v.shape[2] // heads,
                                   bias.dim()))
            return self._orig(q, k, v, bias, heads, *args, **kw)

        att.attention_rows = recorded

    def close(self):
        self.att.attention_rows = self._orig

    def first_call(self, key, fn):
        if key in self.by_signature:
            return fn()
        self.calls = []
        out = fn()
        self.by_signature[key] = self.calls[:len(self.calls) // 2] if (
            len(self.calls) % 2 == 0) else list(self.calls)
        return out

    def totals(self, keys) -> Dict[str, float]:
        from portbench import counts_llm

        flops = nbytes = 0.0
        for key in keys:
            for call in self.by_signature.get(key, []):
                f, b = counts_llm.mla_call(*call)
                flops, nbytes = flops + f, nbytes + b
        return {"flops": flops, "bytes": nbytes, "dtype": "bfloat16"}


def load_summary(load: np.ndarray) -> Dict[str, Any]:
    """The max / mean expert load of each expert layer, and the routed rows
    in all (``load``: [layers, experts] routed-row counts)."""
    mean = load.mean(axis=1)
    ratio = np.where(mean > 0, load.max(axis=1) / np.maximum(mean, 1), 0.0)
    return {"routed_rows": int(load.sum()),
            "max_over_mean": [round(float(x), 3) for x in ratio],
            "max_over_mean_worst": round(float(ratio.max()), 3)
            if ratio.size else 0.0}


def launches() -> Dict[str, int]:
    """The launch counters of the encoder's kernels (a graph replay adds
    its capture's launches): route, permute, the grouped GEMM, combine,
    and the attention with v narrower than q."""
    from ruart_tpu_torch.ops import attention as att
    from ruart_tpu_torch.ops import moe

    return {"route": moe.route_cuda.launches,
            "permute": moe.permute_cuda.launches,
            "grouped_gemm": moe.grouped_gemm_cuda.launches,
            "combine": moe.combine_cuda.launches,
            "attention_192_128": att.attention_rows_cuda.wide_launches}
