"""TSV pair-row parsing: base64 RoI features/boxes/labels + query tokenization.

One row of the KDD Cup data is
``product_id \t image_h \t image_w \t num_boxes \t boxes_b64 \t feats_b64 \t
class_labels_b64 \t query \t query_id``
with boxes float32[N,4], features float32[N,2048], labels int64[N]
(reference ``code/imagebert_lds/src/load_data_pred.py:94-121``; identical in
``imagebert_zk/load_data_v4.py:133-163`` modulo the sen2forest rewrite, and
``lxmert/src/utils.py:23-59`` which keeps 4-dim boxes).

Box geometry follows the reference exactly: columns divided by
``[h, w, h, w]`` and the 5th column ``(c2-c0)*(c3-c1)/(w*h)``
(``load_data_pred.py:101-105``).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass

import numpy as np

SEN2FOREST_SRC = "sen department of"
SEN2FOREST_DST = "forest style"

MAX_QUERY_LEN_AB = 20  # [CLS] + pieces + [SEP], truncated (imagebert A/B/C)
MAX_QUERY_LEN_L = 23  # lxmert (tasks/kdd_data.py:14)
MAX_BOXES = 10
MAX_LABEL_TOKENS = 8


@dataclass
class RawExample:
    """A fully decoded pair row, before any layout-specific padding."""

    product_id: int
    image_h: int
    image_w: int
    num_boxes: int
    boxes: np.ndarray  # float32 [N, 4] raw pixel coords
    features: np.ndarray  # float32 [N, 2048]
    class_labels: np.ndarray  # int64 [N]
    query: str
    query_id: int

    def boxes_normalized(self) -> np.ndarray:
        """float32 [N, 4]: columns / [h, w, h, w] (lxmert layout)."""
        scale = np.array(
            [self.image_h, self.image_w, self.image_h, self.image_w],
            dtype=np.float64,
        )
        return (self.boxes / scale).astype(np.float32)

    def boxes_5(self) -> np.ndarray:
        """float32 [N, 5]: normalized coords + relative area (imagebert)."""
        out = np.zeros((self.num_boxes, 5), dtype=np.float32)
        out[:, :4] = self.boxes_normalized()
        out[:, 4] = (
            (self.boxes[:, 2] - self.boxes[:, 0])
            * (self.boxes[:, 3] - self.boxes[:, 1])
            / (self.image_w * self.image_h)
        )
        return out


def parse_line(line: str) -> RawExample:
    arr = line.rstrip("\n").split("\t")
    product_id = int(arr[0])
    image_h = int(arr[1])
    image_w = int(arr[2])
    num_boxes = int(arr[3])
    boxes = np.frombuffer(base64.b64decode(arr[4]), dtype=np.float32).reshape(
        num_boxes, 4
    )
    features = np.frombuffer(base64.b64decode(arr[5]), dtype=np.float32).reshape(
        num_boxes, 2048
    )
    class_labels = np.frombuffer(base64.b64decode(arr[6]), dtype=np.int64).reshape(
        num_boxes
    )
    return RawExample(
        product_id=product_id,
        image_h=image_h,
        image_w=image_w,
        num_boxes=num_boxes,
        boxes=boxes,
        features=features,
        class_labels=class_labels,
        query=arr[7],
        query_id=int(arr[8]),
    )


def is_header(line: str) -> bool:
    """The reference skips any line containing 'product_id'."""
    return "product_id" in line


def rewrite_sen2forest(query: str) -> str:
    """ImageBERT-C's data-side query rewrite (zk load_data_v4.py:153-154)."""
    return query.replace(SEN2FOREST_SRC, SEN2FOREST_DST)


def pad_1d(ids, maxlen: int, pad_value: int = 0) -> np.ndarray:
    """seq_padding semantics: pad right with pad_value or truncate to maxlen."""
    ids = list(ids[:maxlen])
    return np.asarray(ids + [pad_value] * (maxlen - len(ids)))


def row_mask(n: int, maxlen: int) -> np.ndarray:
    """int32 [maxlen]: 1 at the first n positions, 0 after."""
    return (np.arange(maxlen) < n).astype(np.int32)


def pad_rows(rows: np.ndarray, maxlen: int, pad_value: float = 0.0) -> np.ndarray:
    """seq_padding_2 semantics on one [N, D] array -> [maxlen, D]."""
    n, d = rows.shape
    if n >= maxlen:
        return rows[:maxlen]
    pad = np.full((maxlen - n, d), pad_value, dtype=rows.dtype)
    return np.concatenate([rows, pad], axis=0)

