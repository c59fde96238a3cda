"""PyTorch/CUDA port of the KDD Cup 2020 "Multimodalities Recall" 2nd-place stack.

A second package beside the JAX one (``kddcup_2020_multimodalitiesrecall_2nd_place_tpu``),
which stays the reference that every module here is tested against. The
port imports ``torch`` and ``numpy`` only; every TPU kernel of the ported
path is a hand-written CUDA kernel for Hopper (``csrc/``), with a plain
PyTorch version beside it (``ops/``).

Ported so far: scoring with all four scorers, ImageBERT-A, -B, -C and LXMERT
(tokenizers, data layer, models, scoring engine, ``cli/score.py``), under
each attention backend, the AOT serving export (``serving/``,
``cli/export.py``), ImageBERT-A and LXMERT training (``data/sampling.py``,
``ops/train_blocks.py``, ``train/``, ``cli/train.py``), the native TSV parser
and its span loader (``data/native/``, ``data/fast_pipeline.py``), the
one-shot run, four scorers fused into the
top-5 submission (``ensemble/``, ``cli/submission.py``, ``cli/main.py``),
the import of the reference's TF1 and torch checkpoints (``checkpoint/``,
``cli/convert_checkpoint.py``), distillation into shallower students
(``train/distill.py``, ``cli/distill.py``, ``cli/score_fidelity.py``) and
two-tower recall in front of the cross-encoders (``models/two_tower.py``,
``data/catalog.py``, ``cli/recall.py``, ``cli/cascade.py``,
``cli/bench_recall_3m.py``). ROADMAP.md lists what is still to come.
"""

__version__ = "0.1.0"

from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parent
REPO_ROOT = PACKAGE_ROOT.parent
ASSETS_DIR = REPO_ROOT / "assets"
VOCAB_PATH = ASSETS_DIR / "user_data" / "vocab.txt"
BERT_CONFIG_PATH = ASSETS_DIR / "user_data" / "bert_config.json"
BUILD_DIR = REPO_ROOT / "build"
