"""Label-text dictionary: ``multimodal_labels.txt`` -> cleaned label texts.

``label_id \t label_text`` with ``, . ( )`` replaced by spaces, then stripped
(reference ``load_data_pred.py:33-37``, ``lxmert/src/tasks/kdd_data.py:27-32``).
The hard-negative index of the training samplers is not ported yet.
"""

from __future__ import annotations


def load_multimodal_labels(path) -> dict[str, str]:
    out: dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            arr = line.strip().split("\t")
            if len(arr) < 2:
                continue
            text = (
                arr[1]
                .replace(",", " ")
                .replace(".", " ")
                .replace("(", " ")
                .replace(")", " ")
            )
            out[arr[0]] = text.strip()
    return out
