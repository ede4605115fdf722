"""A short tracked chain through the JAX package and the port, each frame
seeded with that package's previous tracked pose, on the same map and
frames with the JAX random draws replayed.

At ``k_fine`` 96 the small scene covers most of the frame and both
packages track it; at ``k_fine`` 16 the truncated per-tile lists leave most
of the frame uncovered and both lose it alike: what decides the outcome is
the scene's coverage at the configured ``k_fine``, not the package.

Tolerances: each frame's pose within 0.5 mm and 1e-3 rad of the JAX
package's, and iteration counts exact (as test_torch_tracking.py's
single-frame parity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monogs_tpu.ops import se3 as jse3
from monogs_tpu.slam import tracking as jtrack
from monogs_tpu_torch.ops import se3 as tse3
from monogs_tpu_torch.render import renderer as tr
from monogs_tpu_torch.slam import tracking as ttrack
from tests.test_torch_ops import t
from tests.test_torch_render import frames, world
from tests.test_torch_tracking import TRACK, replay_draws
from tests.torch_one_thread import one_torch_thread  # noqa: F401

# per-frame motion: about 27 mm and 5 mrad
STEP = np.float32([0.02, -0.015, 0.01, 0.004, -0.003, 0.002])


@pytest.mark.parametrize("k_fine, tracks", [(96, True), (16, False)])
def test_chain_parity_and_coverage(k_fine, tracks):
    jg, tg, T_gt, _, ji, ti, jc, tc = world(seed=7)
    jc, tc = jc._replace(k_fine=k_fine), tc._replace(k_fine=k_fine)
    poses = [np.asarray(jse3.retract(T_gt, STEP * i)) for i in range(5)]
    cover = float(tr.render(tg, t(T_gt), ti, tc._replace(
        with_n_touched=False)).opacity.mean())
    jtc = jtrack.TrackConfig(monocular=True, **TRACK)
    ttc = ttrack.TrackConfig(monocular=True, **TRACK)
    T_j, T_t = poses[0], t(poses[0])
    err, hold = [], []
    for i in range(1, len(poses)):
        jf, tf = frames(jg, poses[i], ji, jc, False)
        key = jax.random.PRNGKey(100 + i)
        a = jtrack.track_frame(jg, jf, jnp.asarray(T_j), jnp.float32(1.0),
                               jnp.float32(0.0), key, ji, jc, jtc)
        b = ttrack.track_frame(tg, tf, T_t, 1.0, 0.0, None, ti, tc, ttc,
                               draws=replay_draws(key, 64, jtc))
        T_j, T_t = np.asarray(a.T), b.T
        assert (b.fo_iters, b.so_iters) == (int(a.fo_iters), int(a.so_iters))
        dt, dr = tse3.pose_diff(T_t, t(T_j))
        assert float(dt) < 5e-4 and float(dr) < 1e-3, (i, float(dt))
        err.append(float(tse3.pose_diff(T_t, t(poses[i]))[0]))
        hold.append(float(tse3.pose_diff(t(poses[i - 1]), t(poses[i]))[0]))
    # chip_smoke.py's accuracy check: mean error under half of holding the
    # previous frame's pose
    assert (np.mean(err) < 0.5 * np.mean(hold)) == tracks, (cover, err)
    assert (cover > 0.8) == tracks, cover
