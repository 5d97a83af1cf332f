"""Checks that need an NVIDIA GPU: they skip on the CPU and run on the card
(`python chip_smoke.py` runs the same phases at full size)."""

import pytest

import jax

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    import chip_smoke

    return chip_smoke


def test_dfx_error_free_transforms_on_card(card):
    """Double-f32 add/mul survive the GPU compiler's FMA contraction."""
    card.phase_dfx()


def test_kernels_match_scan_on_card(card):
    """The compiled stage-recursion kernels against the `lax.scan` over the
    same stage functions, at N=200, B=32768."""
    import jax.numpy as jnp

    from trajectory_optimization_matrix_lie_groups.tasks import se3_bench

    _, params, q0, xi0, _, _ = se3_bench.build_problem(jnp.float32)
    card.phase_kernels(params["dyn"], params["cost"], q0, xi0)
