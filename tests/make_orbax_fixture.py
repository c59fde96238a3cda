"""Regenerates ``tests/data/orbax_tiny_a/`` and ``tests/data/orbax_tiny_a.npz``:
a tiny ImageBERT-A param tree (``FIXTURE_OVERRIDES``, numpy params from seed
0) written by the JAX package's own ``save_pytree`` (orbax and tensorstore,
jax.Array leaves, as ``scripts/train.py`` writes ``step_<N>``) and by its
``save_npz``. ``tests/test_torch_orbax.py`` holds the two equal through the
port's reader, and ``chip_smoke.py`` reads both on the card's machine, which
has no orbax. Run from the repository's root:

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py
"""

import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

FIXTURE = HERE / "data" / "orbax_tiny_a"
FIXTURE_OVERRIDES = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 37,
                     "vocab_size": 101, "max_position_embeddings": 64}


def main() -> None:
    import jax
    import jax.numpy as jnp

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.checkpoint import save_npz, save_pytree
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model
    from torch_parity import jax_imagebert_a_params

    tree = jax_imagebert_a_params(get_model("imagebert_a", overrides=FIXTURE_OVERRIDES).config, 0)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    save_pytree(FIXTURE, jax.tree.map(jnp.asarray, tree))
    save_npz(FIXTURE.with_suffix(".npz"), tree)
    print(f"wrote {FIXTURE} and {FIXTURE.with_suffix('.npz')}")


if __name__ == "__main__":
    main()
