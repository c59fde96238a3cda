"""Label-text dictionary and the query-label index of negative mining.

* ``multimodal_labels.txt``: ``label_id \t label_text`` with ``, . ( )``
  replaced by spaces, then stripped (reference ``load_data_pred.py:33-37``,
  ``lxmert/src/tasks/kdd_data.py:27-32``).
* ``query_labels.txt``: ``product_id \t query \t labels_csv`` -> the two
  inverted indices of the hard-negative samplers, last query word -> rows and
  box label -> rows (``load_data_v4.py:45-70``; the JAX package's
  ``data/labels.py`` :35-69).
"""

from __future__ import annotations

from dataclasses import dataclass, field


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


@dataclass
class QueryLabelIndex:
    """Inverted indices over query_labels.txt rows for negative mining."""

    rows: list[str] = field(default_factory=list)
    by_tail_word: dict[str, list[int]] = field(default_factory=dict)
    by_label: dict[str, list[int]] = field(default_factory=dict)
    query_set: set[str] = field(default_factory=set)

    @classmethod
    def load(cls, path) -> "QueryLabelIndex":
        idx = cls()
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                arr = line.strip().split("\t")
                if len(arr) < 3:
                    continue
                idx.by_tail_word.setdefault(arr[1].split(" ")[-1], []).append(i)
                idx.query_set.add(arr[1].strip())
                seen: set[str] = set()
                for label in arr[2].split(","):
                    label = label.strip()
                    if label in seen:
                        continue
                    seen.add(label)
                    idx.by_label.setdefault(label, []).append(i)
                idx.rows.append(line.strip())
        return idx

    @staticmethod
    def parse_row(row: str) -> tuple[int, str, list[str], str]:
        """-> (product_id, query, class_labels, query_tail_word)."""
        arr = row.strip().split("\t")
        query = arr[1]
        return int(arr[0]), query, arr[2].split(","), query.split(" ")[-1]
