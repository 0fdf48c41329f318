"""Port vs JAX: SNN neuron dynamics and the kernels' encoder constants.

Tolerance: none. Every compared value is produced by the same sequence of
float32 operations on both sides (or is an integer / a spike), so spikes,
membranes and periods must be bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_automotive_object_detection_tpu.snn import functional as jf
from snn_automotive_object_detection_tpu_torch.snn import functional as tf
from tests.torch_threads import two_torch_threads  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("num_steps", [1, 6, 8, 12, 16, 32])
def test_encoder_thresholds_bit_equal_to_jax(num_steps):
    # The JAX kernels' constants (pallas_rpn.py:384-385, pallas_fc6.py:196-197).
    a = 1.0 - jf.DT * jf.ENCODER_PARAMS.tau_mem_inv
    want = np.asarray(1.0 - a ** jnp.arange(1, num_steps + 1, dtype=jnp.float32))
    got = tf.encoder_thresholds(num_steps)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("num_steps", [6, 8, 12])
def test_li_coefficients_bit_equal_to_jax(num_steps):
    from snn_automotive_object_detection_tpu.snn.pallas_rpn import _li_coefficients

    want = _li_coefficients(num_steps)
    got = tf.li_coefficients(num_steps)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_lif_li_encoder_steps_bit_exact(rng):
    shape = (64, 96)
    x = rng.uniform(-0.5, 2.0, shape).astype(np.float32)
    cur = [rng.normal(0, 0.3, shape).astype(np.float32) for _ in range(10)]

    jv_enc = jnp.zeros(shape)
    tv_enc = torch.zeros(shape)
    jl, tl = jf.zeros_lif_state(shape), tf.zeros_lif_state(shape)
    ji, ti = jf.zeros_li_state(shape), tf.zeros_li_state(shape)
    total = 0
    for c in cur:
        jz, jv_enc = jf.lif_current_encoder(jnp.asarray(x), jv_enc)
        tz, tv_enc = tf.lif_current_encoder(_t(x), tv_enc)
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        np.testing.assert_array_equal(tv_enc.numpy(), np.asarray(jv_enc))

        js, jl = jf.lif_feed_forward_step(jnp.asarray(c), jl)
        ts, tl = tf.lif_feed_forward_step(_t(c), tl)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tl.v.numpy(), np.asarray(jl.v))
        np.testing.assert_array_equal(tl.i.numpy(), np.asarray(jl.i))
        total += int(ts.sum())

        jm, ji = jf.li_feed_forward_step(jnp.asarray(c), ji)
        tm, ti = tf.li_feed_forward_step(_t(c), ti)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ti.i.numpy(), np.asarray(ji.i))
    assert total > 0, "the LIF layer never spiked"


def test_encoder_periods_and_spikes_bit_exact(rng):
    x = rng.uniform(-0.5, 3.0, (128, 200)).astype(np.float32)
    jp = np.asarray(jf.encoder_periods(jnp.asarray(x)))
    tp = tf.encoder_periods(_t(x))
    np.testing.assert_array_equal(tp.numpy(), jp)
    for t in range(12):
        want = np.asarray(jf.encoder_spikes_at(jnp.asarray(jp), jnp.asarray(t)))
        np.testing.assert_array_equal(tf.encoder_spikes_at(tp, t).numpy(), want)


@pytest.mark.parametrize("num_steps", [6, 12])
def test_threshold_periods_match_closed_form(rng, num_steps):
    """The kernels' threshold count equals encoder_periods wherever that
    period spikes within T steps, and is T + 1 otherwise."""
    x = rng.uniform(-0.5, 3.0, (64, 256)).astype(np.float32)
    thr = torch.from_numpy(tf.encoder_thresholds(num_steps))
    got = tf.threshold_periods(_t(x), thr).numpy()
    want = np.asarray(jf.encoder_periods(jnp.asarray(x))).astype(np.int32)
    want = np.where(want <= num_steps, want, num_steps + 1)
    np.testing.assert_array_equal(got, want)
