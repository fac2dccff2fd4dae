"""The RGB merge (merge_burst_fast) past scale 4, where the card runs the
general kernel form of csrc/merge.cu: its phase-layout forms at scales 5
and 6 against the JAX function (tests/test_torch_port_limits.py has the
rest of the port's former limits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast_plain
from multi_frame_super_resolution_tpu_torch.models import fast_merge

# order 0 sums w c v and w c: rounding alone; the order-1 moments sum
# terms of mixed sign up to (r + rb) s (tests/test_torch_knob_merge.py)
TOL = dict(rtol=1e-5, atol=1e-5)
ORDER1_TOL = dict(rtol=1e-4, atol=1e-4)


# merge_burst_fast's phase-layout forms (1-4 of csrc/merge.cu)
RGB_FORMS = {
    "order0": (dict(phase_output=True), TOL),
    "order1": (dict(phase_output=True, order=1, moment_slots=4), ORDER1_TOL),
    "slots9": (dict(phase_output=True, order=1, moment_slots=9), ORDER1_TOL),
    "bf16": (dict(phase_output=True, bf16=True), None),
}


@pytest.mark.parametrize("scale", [5, 6])
@pytest.mark.parametrize("form", list(RGB_FORMS))
def test_rgb_merge_forms_match_jax_past_scale_4(form, scale):
    """merge_burst_fast's phase-layout forms at scales 5 and 6 against the
    JAX function, jitted as the pipeline runs it, with k_max (s/2)^2 and
    five taps (XLA:CPU compiles the merge's s^2 phases per tap in 5-25 s
    here): float32 at each form's tolerance, the bfloat16 form bit for
    bit (tests/test_torch_knob_merge.py's rule)."""
    kw, tol = RGB_FORMS[form]
    rng = np.random.default_rng(400 + scale + len(form))
    f, h, w = 2, 6, 7
    ins = (
        rng.random((f, h, w, 3)).astype(np.float32),
        ((rng.random((f, h, w, 2)) - 0.5) * 2.0).astype(np.float32),
        rng.random((f, h, w, 3)).astype(np.float32),
        np.concatenate([0.5 + rng.random((h, w, 2)), 0.05 + 0.1 * rng.random((h, w, 1))], -1).astype(np.float32),
    )
    # radius 0 and residual bound 0.1 at e^-0.6: the 5 taps of a cross
    args = (scale, 0, 0.1, (scale / 2.0) ** 2)
    kw = dict(kw, prune_exp=0.6)
    assert len(fast_merge._active_taps(1, 0.1, scale, (scale / 2.0) ** 2, 0.6)) == 5

    def jax_merge(*xs):
        return jfm.merge_burst_fast(*xs, *args, **kw)

    want = jax.jit(jax_merge)(*map(jnp.asarray, ins))
    got = merge_fast_plain(*map(tt, ins), *args, **kw)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.shape == (scale, scale, 3, h, w)
        if tol is None:
            np.testing.assert_array_equal(nn(g), np.asarray(w_, np.float32))
        else:
            np.testing.assert_allclose(nn(g), np.asarray(w_), **tol)
