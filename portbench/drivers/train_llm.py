"""The training path of ``train.py`` with the Moonlight-16B-A3B encoder in
BERT's slot (the ``LLM_ENCODER`` conf key, BF16): ``Trainer.train_step``
replaying one CUDA graph per batch signature, fed by the trainer's
pipeline, losses drained every ``drain_every`` steps; the same set-up,
checked steps and window as ``train.py`` (its :class:`Start`,
:func:`sampler_for` and :func:`_drain`).

What differs: the model is built on the device, the fusion weights from
``build.make_weights`` and the encoder's drawn per parameter in bf16
(``llm.py``); the configuration's encoder (its ``bert`` block, the
published config.json's keys) reaches the conf as a config.json written
for the run (``LLM_ENCODER``). The per-expert routed-row counter of the
program and the encoder kernels' launch counters are read before and
after the window (the notes: ``expert_load``, ``launches_per_step``).

How the reference judges the run. A bf16 program and an fp32 reference
do not take the same discrete routes through 26 expert layers: a route
flipped by rounding changes what the next layers see, and the two drift
apart (on the first sound run at the published widths, seed 2147483701,
12.7% of the routes differed and the median token's α-combined output
was 16% away; PERF.md §6). So the check is made where it is exact:

* ``train.encoder``: after the window the program's encoder runs the
  first checked batch block by block through its own modules
  (``llm.program_blocks``; its layer outputs must equal its forward's,
  else the number is inf); the reference's encoder computes each block on
  the program's own input to that block, in fp32 (the router then sees
  the same rows); the worst per-token gap of any block,
  ||program - reference|| / ||reference|| over one real token's width
  (``llm.check_blocks``). Per token, so a fault confined to a few tokens
  (one segment's positions, a mask edge, one expert) is not spread over
  the batch. The router's logits are the same fp32 product of the same
  rows on both sides, so the routes agree exactly (PERF.md §6).
* ``train.loss``, ``train.grad``, ``train.change``: the three checked
  replays against the reference's three steps on the same batches, its
  encoder slot replaying the program's own encoder outputs for those
  batches (``llm.Replay``), so they judge the fusion path and its
  α-combine, as in ``train.py``.

``run.control`` puts a control or a planted fault in the program's place:
of the encoder (``reference.moonlight.FAULTS``: the reference encoder
with it, its blocks free-running, judged as the program's; its fusion
steps are then the reference's own), or of the fusion path
(:data:`FUSION_CONTROLS`: the reference's steps in TF32, or with half of
each batch left out of the loss).
"""

from __future__ import annotations

import shutil
import tempfile
import time

from portbench import check, corpus, counts_llm, llm, trace
from portbench.drivers import common
from portbench.drivers.train import CHECKED, Start, _drain, sampler_for
from portbench.harness import Outcome


def build(run, spans, phases, conf_path):
    import torch

    from ruart_tpu_torch.data.collate import Collator
    from ruart_tpu_torch.data.dataset import VQADataset
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.models.moonlight.config import MoonlightConfig
    from ruart_tpu_torch.text.wordpiece import (
        WordPieceTokenizer, build_demo_vocab)
    from ruart_tpu_torch.train.loss import make_loss_fn
    from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
    from ruart_tpu_torch.train.train_step import (
        init_train_state, make_train_step)
    from ruart_tpu_torch.train.trainer import Trainer

    t = run.traffic
    extra = dict(common.data_keys(run), LLM_ENCODER=conf_path)
    cfg = common.program_conf(run, extra)
    raw = corpus.make_items(t["items"], run.seed, t.get("corpus"),
                            with_answers=True)
    phases.mark("items")
    tok = WordPieceTokenizer(build_demo_vocab())
    tr = Trainer(cfg, MoonlightConfig.from_json(conf_path), device=run.device)
    data = common.featurize(tr.preproc, raw)
    phases.mark("featurize")
    tr.vocab = tr.preproc.train_vocab
    tr.tokenizer = tok
    tr.spec = ModelSpec.from_config(cfg, tr.bert_config)
    tr._int8_eval = False
    with tr.device:
        model = RUArtModel(tr.spec)
    llm.fusion_weights(model, run.seed)
    llm.draw_encoder(model.Bert, run.seed)
    phases.mark("weights")
    tr.collator = common.TimedCollator(Collator(cfg), spans)
    tr._h2d_slim = bool(int(cfg.opt.get("h2d_slim", 1)))
    tr._setup_mesh(model)
    tune = int(cfg.opt["tune_partial"]) if "TUNE_PARTIAL" in cfg.opt else None
    tr.optimizer = Optimizer(
        str(cfg.opt.get("optimizer", "#")),
        float(cfg.opt["lr"]) if "lr" in cfg.opt else None,
        float(cfg.opt.get("grad_clipping", 10)), tr.model, tr.spec,
        tune is not None, mesh=tr.mesh)
    tr.loss_fn = make_loss_fn(str(cfg.opt.get("loss", "BCE_D1")))
    tr.train_step = make_train_step(
        tr.loss_fn, make_row_pinner(tr.model, tr.spec, tune))
    tr.state = init_train_state(tr.model, tr.optimizer, cfg.seed)
    train_data = VQADataset(data, cfg, mode="train", tokenizer=tok)
    phases.mark("model")
    return tr, raw, extra, train_data, torch


class Reference(check.Reference):
    """The reference with the Moonlight encoder in BERT's slot; the conf
    without BF16 (the reference is fp32)."""

    def __init__(self, config, extra, device, seed, conf_path):
        import torch

        from portbench.reference.config import Config, read_conf_lines
        from portbench.reference.moonlight import MoonlightConfig

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        conf = dict(config, conf={k: v for k, v in config["conf"].items()
                                  if k != "BF16"})
        self.cfg = Config(read_conf_lines(build_lines(conf, extra)))
        self.bert = MoonlightConfig.from_json(conf_path)
        # the encoder's weights hold the program's values: bf16 under BF16
        self.weight_dtype = (torch.bfloat16 if "BF16" in config["conf"]
                             else torch.float32)
        self.device = torch.device(device)
        self.seed = seed
        self.model = None

    def build_model(self, fault=None):
        from portbench.reference.collate import Collator
        from portbench.reference.moonlight import ruart_model
        from portbench.reference.spec import ModelSpec

        self.model = None
        common.free_memory()
        self.spec = ModelSpec.from_config(self.cfg, self.bert)
        with self.device:
            model = ruart_model(self.spec, self.weight_dtype)
        llm.fusion_weights(model, self.seed)
        llm.draw_encoder(model.Bert, self.seed)
        model.Bert.fault = fault
        self.model = model
        self.collator = Collator(self.cfg)
        return model


# the controls and faults of the fusion path; the encoder's are
# reference.moonlight.FAULTS
FUSION_CONTROLS = ("tf32", "half_batch")


def fusion_steps(ref, batches, outputs, **kw):
    """``check.reference_steps`` with the reference model's encoder slot
    replaying ``outputs`` (the program's encoder outputs of the batches'
    encoder calls, in call order)."""
    encoder = ref.model.Bert
    ref.model.Bert = llm.Replay(outputs)
    try:
        return check.reference_steps(ref, batches, **kw)
    finally:
        ref.model.Bert = encoder


def build_lines(config, extra):
    from portbench.build import conf_lines

    return conf_lines(config, {k: v for k, v in extra.items()
                               if k != "LLM_ENCODER"})


def run(run) -> Outcome:
    from ruart_tpu_torch.data.pipeline import batch_iterator, host_batch, prefetch
    from ruart_tpu_torch.utils.graphs import signature

    folder = tempfile.mkdtemp(prefix="portbench-llm-")
    try:
        conf_path = llm.conf_file(run.config, folder)
        spans, phases = common.Spans(), common.Phases()
        tr, raw, extra, train_data, torch = build(run, spans, phases,
                                                  conf_path)
        return _run(run, conf_path, spans, phases, tr, raw, extra,
                    train_data, torch, batch_iterator, host_batch, prefetch,
                    signature)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def _run(run, conf_path, spans, phases, tr, raw, extra, train_data, torch,
         batch_iterator, host_batch, prefetch, signature) -> Outcome:
    cuda = tr.device.type == "cuda"
    mla = llm.MlaCalls() if cuda else None
    t = run.traffic
    bs = tr.cfg.batch_size
    sampler = common.RecordingSampler(sampler_for(tr, len(train_data)))
    # the producer thread outlives the run, blocked on its full queue: it
    # must not hold the trainer (and the 31 GB encoder) through
    # tr._host_put
    spec, slim = tr.spec, tr._h2d_slim
    feed = prefetch(batch_iterator(train_data, sampler, tr.collator,
                                   num_workers=int(tr.cfg.opt.get("num_worker", 0))),
                    size=2, host_put=lambda b: host_batch(b, spec, slim,
                                                          pin=cuda))
    keys = []

    def step(host):
        q, ocr, od, gt, _extra = tr._device_put(host)
        key = signature((q, ocr, od, gt))
        keys.append(key)

        def go():
            return tr.train_step(tr.state, q, ocr, od, gt)

        tr.state, loss = mla.first_call(key, go) if mla else go()
        return loss

    def n_graphs():
        graphs = tr.train_step.graphs
        return len(graphs) if graphs is not None else 0

    start_state = Start(tr.state)
    horizon = CHECKED + int(t["max_steps_per_s"] * run.seconds) + 1
    ahead = sampler_for(tr, len(train_data))
    want, items = {}, {}
    for n, idx in enumerate(ahead):
        if n >= horizon:
            break
        for i in idx:
            if i not in items:
                items[i] = train_data[i]
        batch = tr.collator.collator([items[i] for i in idx])
        key = signature(host_batch(batch, tr.spec, tr._h2d_slim)[:4])
        if key not in want:
            want[key] = batch
    del items
    phases.mark("signature_scan")
    for _ in range(2):  # its capture, then its first replay
        for batch in want.values():
            step(tr._host_put(batch))
    phases.mark("captures")

    start_state.restore(tr.state)
    before = n_graphs()
    losses, grads = [], {}
    opt = tr.optimizer
    b1 = 0.9
    for i in range(CHECKED):
        losses.append(step(next(feed)))
        if i == 0:
            grads = {n: float(st["mu"].double().norm()) / (1 - b1)
                     for n, st in opt.state.items()}
    changes = {n: float((p.detach() - start_state.params[n]).double().norm())
               for n, p in opt.params.items()}
    checked_captures = n_graphs() - before
    del start_state
    prog = {"loss": [float(x) for x in losses], "grad": grads,
            "change": changes}
    phases.mark("checked_steps")
    captures_before = n_graphs()
    load = tr.model.Bert.expert_load
    load_before = load.cpu().numpy()
    if cuda:
        torch.cuda.synchronize()

    seconds = run.seconds if not run.trace else min(
        run.seconds, float(t.get("trace_seconds", run.seconds)))
    drain_every = int(t.get("drain_every", 30))
    pending, failed, steps = [], 0, 0
    setup_s = run.setup_s()
    first_window_key = len(keys)
    launches_before = llm.launches()
    spans.on = run.trace
    with trace.Session(run.trace) as session, common.HostWatch() as host:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            pending.append(step(next(feed)))
            steps += 1
            if steps % drain_every == 0:
                failed += _drain(pending, torch)
        failed += _drain(pending, torch)
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - start
    spans.on = False
    launched = {k: (n - launches_before[k]) / max(steps, 1)
                for k, n in llm.launches().items()}
    captures = n_graphs() - captures_before
    window_load = load.cpu().numpy() - load_before
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_keys = keys[first_window_key:]
    fed = sampler.batches[CHECKED:CHECKED + steps]
    checked_idx = sampler.batches[:CHECKED]
    mla_totals = mla.totals(window_keys) if mla else None
    if mla:
        mla.close()

    # the program's encoder on the checked batches: every layer's output of
    # each encoder call (for the reference's fusion steps), and on the
    # first batch block by block (for train.encoder)
    outputs, first_calls, first_blocks, forward_equal = [], [], [], True
    for b, idx in enumerate(checked_idx):
        collated = tr.collator.collator([train_data[i] for i in idx])
        q, ocr, od, _gt, _more = tr._device_put(tr._host_put(collated))
        for call in llm.encoder_calls(tr.model, q, ocr, od):
            layers = llm.program_outputs(tr.model.Bert, call)
            outputs.append((call["ids"], layers))
            if b == 0:
                blocks = llm.program_blocks(tr.model.Bert, call)
                forward_equal &= all(
                    torch.equal(blk["x"], layers[i - 1])
                    for i, blk in enumerate(blocks[1:-1], 1)) and torch.equal(
                        blocks[-1]["norm"], layers[-1])
                first_calls.append(call)
                first_blocks.append(blocks)
    tr.train_step.release()
    warmed = len(want)
    enc_config = tr.spec.bert
    del tr, feed, want, q, ocr, od, load
    common.free_memory()

    # the reference: its fusion steps on the program's encoder outputs
    # (llm.Replay), its encoder block by block on the program's inputs
    ref = Reference(run.config, extra, run.device, run.seed, conf_path)
    ds = ref.featurize(raw, raw, "train")
    ref.build_model()
    batches = [ref.collate([ds[i] for i in idx]) for idx in checked_idx]
    ref_steps = fusion_steps(ref, batches, outputs)
    if run.control in FUSION_CONTROLS:
        # the control of the fusion path (the reference in TF32) or a fault
        # there (half of each batch left out of the loss) in the program's
        # place: the reference's steps again, from the seed's weights
        ref.build_model()
        with check.precision(run.control == "tf32"):
            prog = fusion_steps(ref, batches, outputs,
                                half_batch=run.control == "half_batch")
    elif run.control is not None:
        # a control or a fault of the encoder in the program's place: the
        # reference encoder with it, free-running; its fusion steps are the
        # reference's own on its outputs
        first_blocks = [llm.reference_blocks(ref.model.Bert, call, run.control)
                        for call in first_calls]
        prog = ref_steps
    del outputs
    encoder = ref.model.Bert
    checks = [llm.check_blocks(encoder, call, blocks)
              for call, blocks in zip(first_calls, first_blocks)]
    del first_blocks
    encoder_gap = {k: max(c[k] for c in checks) for k in checks[0]}
    numbers, worst = check.train_numbers(prog, ref_steps)
    # a probe whose layers are not the forward's own fails the check
    numbers["encoder"] = encoder_gap["token"] if forward_equal else float("inf")
    numbers["checked_captures"] = checked_captures
    compared = check.limited(numbers, run.limits, "train")

    record = {"kind": "train_llm", "spans": spans.seconds,
              "graph_captures": captures, "steps": steps}
    tr_summary = session.read()
    if tr_summary is not None:
        record["trace"] = tr_summary
        flops = {"bert": 0.0, "fp32": 0.0}
        for idx in fed:
            f = counts_llm.model_flops(ref.model, ref.collate([ds[i] for i in idx]),
                                       train=True)
            flops["bert"] += f["bert"]
            flops["fp32"] += f["fp32"]
        record["flops"] = flops
        record["bert_dtype"] = enc_config.dtype
        record["mla"] = mla_totals
        record["moe"] = counts_llm.moe_window(window_load, steps, enc_config)
    e2e = {"train_questions_per_s": steps * bs / window, "setup_s": setup_s}
    out = Outcome(attempted=steps, failed=failed, e2e=e2e, record=record,
                  compared=compared, memory_peak_bytes=peak,
                  trace=tr_summary)
    out.notes = {"worst_leaf": worst, "warmed_signatures": warmed,
                 "captures_in_window": captures,
                 "encoder_blocks": {k: round(v, 7)
                                    for k, v in encoder_gap.items()},
                 "probe_is_the_forward": forward_equal,
                 "expert_load": llm.load_summary(window_load),
                 "launches_per_step": launched,
                 **host.notes(), "setup_phases": phases.seconds}
    return out
