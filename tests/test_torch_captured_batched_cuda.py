"""The port's batched tick replayed from captured CUDA graphs on the card
(``rollout.rollout_batched``: ``rollout.tick_batched_parts`` as a
``utils/graphs.StagedStep``).

- Over a trot and a few edited ticks, each tick replayed equals, bit for
  bit, the eager tick (the sensor half, ``controller.control_step_batched``
  and the plant step) on the same carry, on every route: warm, window,
  compact, cold after the base program's flags overflow the compacted
  sub-batch and cold a priori (the transitions alone overflow it), with
  the segmented cold settings (K1) and the polished ones (K3); the robust
  program too. Each tick counts one route into ``stats`` and replays two
  graphs (cold a priori) or three (``graphs.replays``).
- The capture cache keeps one batched step: capturing at a third
  configuration evicts the first, and the card's reserved memory does not
  grow by a capture each time.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels build at first
use); without a card they skip. This file imports neither JAX nor the JAX
package. On the GPU machine:

    python3 -m pytest --noconftest tests/test_torch_captured_batched_cuda.py
"""

import pytest
import torch

from go1_qp_mpc_controller_torch.ctrl import controller
from go1_qp_mpc_controller_torch.envs import rollout
from go1_qp_mpc_controller_torch.models import types
from go1_qp_mpc_controller_torch.ops import admm
from go1_qp_mpc_controller_torch.utils import graphs

pytestmark = pytest.mark.cuda
F32 = torch.float32
DT = 0.002
BATCH, K = 12, 3                # a batch of compact_k + 9
SETTINGS = {
    # the fleet's segmented cold settings (K1)
    "segmented": admm.ADMMSettings(seg_iters=30, segments=2,
                                   first_seg_iters=20, polish=False,
                                   schulz_l0=1e-6, schulz_l0_first=1e-3,
                                   schulz_l0_refine=1e-4, schulz_hi_tail=1,
                                   schulz_impl="pallas"),
    # main.py's polished cold settings (the dense solve, K3)
    "polished": admm.ADMMSettings(seg_iters=25, segments=3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _start(card, batch=BATCH):
    model = types.default_robot_model(F32, card)
    params = types.default_ctrl_params(F32, card)
    c = rollout.init_carry(model, params, batch, dtype=F32, device=card)
    gen = torch.Generator().manual_seed(0)
    dz = 0.01 * torch.randn((batch, 1), generator=gen)
    dv = 0.02 * torch.randn((batch, 3), generator=gen)
    vel = torch.tensor([[0.25, 0.0, 0.0]], dtype=F32, device=card)
    c = c._replace(
        sim=c.sim._replace(
            root_pos=c.sim.root_pos
            + torch.nn.functional.pad(dz, (2, 0)).to(card),
            root_lin_vel=c.sim.root_lin_vel + dv.to(card)),
        ctrl=c.ctrl._replace(
            movement_mode=torch.ones_like(c.ctrl.movement_mode),
            root_lin_vel_d=vel.expand(batch, 3).clone()))
    return model, params, c


def _same_bits(got, want):
    g, w = graphs.flatten(got)[0], graphs.flatten(want)[0]
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        # bits, so that a NaN equals itself
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), i


def _edit(carry, case):
    """A steady warm carry edited: carried contact patterns flipped
    (transitions) or carried inverses negated (health rejects)."""
    ctrl = carry.ctrl
    if case in ("compact", "prior_overflow"):
        n = 1 if case == "compact" else K + 1
        qc = ctrl.qp_warm_contacts.clone()
        qc[2:2 + n] = ~qc[2:2 + n]
        ctrl = ctrl._replace(qp_warm_contacts=qc)
    elif case == "post_base_overflow":
        minv = ctrl.qp_warm_minv.clone()
        minv[1:K + 2] = -minv[1:K + 2]
        ctrl = ctrl._replace(qp_warm_minv=minv)
    return carry._replace(ctrl=ctrl)


def _tick(carry, model, params, settings, robust=False):
    """One tick captured and one eager on ``carry``: (the captured tick's
    carry, its route, its replays), after holding both to equal bits."""
    stats, eager_stats = {}, {}
    replays = graphs.replays
    got, got_rec = rollout.rollout_batched(
        carry, model, params, 1, DT, settings=settings, robust=robust,
        compact_k=K, stats=stats)
    replays = graphs.replays - replays
    want, want_rec = rollout._run(
        carry, model, params, 1, DT, None, True, None,
        lambda ctrl: controller.control_step_batched(
            ctrl, model, params, DT, settings=settings, robust=robust,
            compact_k=K, stats=eager_stats))
    assert stats == eager_stats
    (route, n), = stats.items()
    assert n == 1
    _same_bits(got, want)
    _same_bits(got_rec, want_rec)
    return got, route, replays


@pytest.mark.parametrize("name", ["segmented", "polished"])
def test_captured_batched_ticks_equal_eager_bits(card, name):
    settings = SETTINGS[name]
    model, params, carry = _start(card)
    seen = set()
    steady = None
    for i in range(90):
        nxt, route, replays = _tick(carry, model, params, settings)
        assert replays == 3 or (route, replays) == ("cold", 2), (
            i, route, replays)
        seen.add((route, replays))
        if route == "warm" and steady is None and i > 45:
            steady = carry
        carry = nxt
    assert steady is not None
    for case, route, replays in (("compact", "compact", 3),
                                 ("prior_overflow", "cold", 2),
                                 ("post_base_overflow", "cold", 3)):
        _, got_route, got_replays = _tick(_edit(steady, case), model,
                                          params, settings)
        assert (got_route, got_replays) == (route, replays), case
        seen.add((route, replays))
    assert {("warm", 3), ("window", 3), ("compact", 3), ("cold", 2),
            ("cold", 3)} <= seen, seen


def test_captured_robust_ticks_equal_eager_bits(card):
    model, params, carry = _start(card)
    for _ in range(50):
        carry, route, replays = _tick(carry, model, params,
                                      SETTINGS["segmented"], robust=True)
        assert (route, replays) == ("robust", 1)


def test_batched_capture_cache_keeps_one(card):
    """Three batched configurations in turn: each capture evicts the one
    before, so the reserved memory stays near one capture's."""
    model, params, carry = _start(card, batch=64)
    reserved, keys = [], []
    for k in (3, 4, 5):
        rollout.rollout_batched(carry, model, params, 1, DT,
                                settings=SETTINGS["segmented"], compact_k=k)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved(card))
        kept = [key for key in rollout._CAPTURED if rollout._batched(key)]
        assert len(kept) == rollout._KEEP_BATCHED == 1
        keys.append(kept[0])
    assert len(set(keys)) == 3
    one = min(rollout._CAPTURES[key][1] for key in keys)
    assert one > 0
    assert reserved[2] - reserved[0] < one / 2, (reserved, one)
