"""The traffic is a function of the seed."""

from portbench import build, corpus


def test_same_seed_same_items():
    seed = 2 ** 31 + 12345  # a seed past 32 signed bits
    a = corpus.make_items(64, seed, with_answers=True)
    b = corpus.make_items(64, seed, with_answers=True)
    assert a == b
    assert a != corpus.make_items(64, seed + 1, with_answers=True)


def test_lexicon_sets_the_vocabulary():
    params = build.read_json("traffic", "train-b16")["corpus"]
    bench = {t["word"] for d in corpus.make_items(256, 5, params)
             for t in d[corpus.OCR_NAME] + d[corpus.ES_NAME]}
    assert bench <= set(corpus.WORDS)
    wide = dict(params, lexicon=30000, zipf=1.0)
    words = {t["word"] for d in corpus.make_items(256, 5, wide)
             for t in d[corpus.OCR_NAME] + d[corpus.ES_NAME]}
    assert len(words) > 1000  # tune_partial
    assert len(set(corpus.lexicon(30000))) == 30000


def test_items_keep_the_mix_ranges():
    params = build.read_json("traffic", "train-b16")["corpus"]
    items = corpus.make_items(200, 7, params, with_answers=True)
    lo, hi = params["ocr_words"]
    assert all(lo <= len(d[corpus.OCR_NAME]) <= hi for d in items)
    lo, hi = params["od_objects"]
    assert all(lo <= len(d[corpus.OD_NAME]) <= hi for d in items)
    assert all(len(d[corpus.ES_NAME]) == params["es_words"] for d in items)
    words = {t["word"] for d in items for t in d[corpus.OCR_NAME]}
    assert all(set(d["answers"]) <= words for d in items)


def test_weights_repeat_for_a_seed():
    import torch

    a = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.LayerNorm(4))
    b = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.LayerNorm(4))
    build.make_weights(a, 5)
    build.make_weights(b, 5)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    build.make_weights(b, 6)
    assert not torch.equal(a[0].weight, b[0].weight)


def test_a_corpus_seed_keeps_the_items_and_changes_the_order():
    params = dict(build.read_json("traffic", "offline-b64")["corpus"])
    a = corpus.make_items(200, 1, params)
    b = corpus.make_items(200, 2, params)
    assert a != b
    key = lambda d: (d["question"], d["image_width"], d["image_height"],
                     str(d[corpus.OCR_NAME]), str(d[corpus.OD_NAME]))
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert [d["question_id"] for d in a] == list(range(200))
    assert a == corpus.make_items(200, 1, params)
