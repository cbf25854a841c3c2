"""Batched inference engine — port of ``ruart_tpu/serve.py::InferenceEngine``.

Takes raw requests (question text + OCR tokens with pixel boxes + object
detections), runs the host featurization pipeline, collates fixed-shape
batches (padding the tail batch by repeating its last item), runs the
RUArt forward on the device and decodes one answer per request.

Request schema (one sample):
    {"question": str,
     "image_width": int, "image_height": int,
     "ocr": [{"word": str, "pos": [8 px quad]}...],
     "od":  [{"object": str, "pos": [cx, cy, w, h] px}...],
     "es":  optional [{"word", "pos", "cnt"}...]}

The engine runs on CUDA unless the caller passes ``device="cpu"``; without
a card it raises. On CUDA fp32 means full fp32: TF32 is turned off for
matmuls and for cuDNN (which also runs the LSTMs).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.collate import Collator
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.pipeline import host_block, put_block
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.eval.decoder import decode_batch
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer

_ZERO8 = [0] * 8
_ZERO4 = [0, 0, 0, 0]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none: the
    port has no silent CPU path. On CUDA, fp32 stays full fp32: TF32 is
    turned off for matmuls and for cuDNN (which also runs the LSTMs)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU (RUART_PLATFORM=cpu for the command-line tools)"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


class InferenceEngine:
    def __init__(
        self,
        cfg: Config,
        spec: ModelSpec,
        params: Mapping[str, Any],
        vocab: Sequence[str],
        tokenizer: WordPieceTokenizer,
        device=None,
    ):
        """``params``: the state dict of ``RUArtModel(spec)`` (tensors or
        numpy arrays), e.g. ``convert.from_jax_params(flax_params)``."""
        self.cfg = cfg
        self.spec = spec
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        with self.device:
            self.model = RUArtModel(spec)
        self.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in params.items()}
        )
        self.model.eval()
        self.collator = Collator(cfg)
        self.batch_size = cfg.batch_size
        self._pre = Preprocessor(cfg)
        self._pre.train_vocab = list(vocab)
        self._pre.gram_word_keys = ("word", "wordid", "pos_id", "ent_id",
                                    "charid")
        self._ocr_name = str(cfg.opt.get("preprocess_ocr_name", "OCR")).split(",")[0]
        self._od_name = str(cfg.opt.get("preprocess_od_name", "OD")).split(",")[0]
        self._es_name = cfg.opt.get("ES_ocr")
        # H2D slimming (`h2d_slim 1`): drop grid keys the model never reads
        # once the packed/unique tables are attached (collate.slim_block)
        self._h2d_slim = bool(int(cfg.opt.get("h2d_slim", 1)))

    # -- host featurization ------------------------------------------------
    def _to_raw_datum(self, sample: Dict[str, Any], qid: int) -> Dict[str, Any]:
        datum = {
            "question": sample["question"],
            "question_id": qid,
            "file_path": sample.get("image_path", ""),
            "image_width": sample.get("image_width", 1),
            "image_height": sample.get("image_height", 1),
            self._ocr_name: [
                {"word": t["word"], "pos": t.get("pos", _ZERO8)}
                for t in sample.get("ocr", [])
            ],
            self._od_name: [
                {"object": t["object"], "pos": t.get("pos", _ZERO4)}
                for t in sample.get("od", [])
            ],
        }
        if self._es_name:
            datum[self._es_name] = [
                {
                    "word": t["word"],
                    "pos": t.get("pos", _ZERO8),
                    "cnt": t.get("cnt", 1),
                    "idx": i,
                }
                for i, t in enumerate(sample.get("es", sample.get("ocr", [])))
            ]
        return datum

    def featurize(self, samples: Sequence[Dict[str, Any]]) -> VQADataset:
        raw = [self._to_raw_datum(s, i) for i, s in enumerate(samples)]
        data = self._pre._process_data(raw)
        self._pre._assign_ids(data)
        return VQADataset(data, self.cfg, mode="test", tokenizer=self.tokenizer)

    def _build_items(self, chunk: Sequence[Dict[str, Any]], base: int = 0):
        """Featurize + build dataset items for ``chunk`` (qids start at
        ``base``)."""
        raw = [self._to_raw_datum(s, base + i) for i, s in enumerate(chunk)]
        data = self._pre._process_data(raw)
        self._pre._assign_ids(data)
        ds = VQADataset(data, self.cfg, mode="test", tokenizer=self.tokenizer)
        return [ds[i] for i in range(len(ds))]

    def _collated_batches(self, samples: Sequence[Dict[str, Any]]):
        """Featurize -> dataset items -> collate, one batch at a time.
        Yields (first_sample_idx, n_real, batch). The tail batch is padded
        by repeating its last item: the whole-tensor layer norm spans the
        batch, so a tail run at its true size would change every score."""
        B = self.batch_size
        for start in range(0, len(samples), B):
            chunk = list(samples[start: start + B])
            items = self._build_items(chunk)
            while len(items) < B:
                items.append(items[-1])
            yield start, len(chunk), self.collator(items)

    def to_device(self, block: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Slim, check and move one collated host block to the device;
        aliased grids (one array under several keys) move once
        (``data.pipeline.host_block`` + ``put_block``)."""
        return put_block(
            host_block(block, self.spec, self._h2d_slim,
                       pin=self.device.type == "cuda"),
            self.device,
        )

    # -- inference -----------------------------------------------------------
    def predict(self, samples: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Returns [{'answer', 'score', 'idx'}] aligned with samples."""
        results: List[Dict[str, Any]] = [None] * len(samples)
        for start, n_real, (q, ocr, od, _gt, extra) in self._collated_batches(
            samples
        ):
            blocks = [self.to_device(b) for b in (q, ocr, od)]
            with torch.inference_mode():
                scores = self.model(*blocks)
            _, save_res, _, _ = decode_batch(
                scores.cpu().numpy(), extra, ocr["num"], None,
                yesno=self.spec.label_yesno,
                label_no_answer=self.spec.label_no_answer,
            )
            for j in range(n_real):
                results[start + j] = {
                    "answer": save_res[j]["prediction"],
                    "score": save_res[j]["score"],
                    "idx": save_res[j]["idx"],
                }
        return results
