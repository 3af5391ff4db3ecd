"""The port's SGD chain, held against the JAX package piece by piece.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in ``flink_ml_tpu_torch`` on the CPU (the plain PyTorch
version of the ``sgd_batch_terms`` kernel). The JAX fits run on a one-device
mesh: on the tests' 8-device mesh every shard would take its own share of
each minibatch, a different schedule from the port's single device.

Tolerances, all float32 against float32:
- batch terms against the Pallas kernel in interpret mode: rtol 2e-5,
  atol 1e-5, the bound of the JAX package's own kernel test (sums of 16
  rows added in another order), at widths past 512 too (dots of up to
  1,500 terms, the coefficients scaled by 1/√d so that the margins stay
  near 1); at 13,210 and 16,000 columns atol 5e-5: a dot of that many
  terms is about 1.6e-6 off its float64 value, the least-square
  multiplier (dot − y) passes that on unscaled, and a column sums 32 rows
  of such products (32 × 1.6e-6 ≈ 5e-5 where the errors share a sign);
  past 16,000 columns atol 5e-5·√(d / 16,000): a dot's rounding errors
  add up as a random walk over its d terms, so its error grows as √d
  (1.3e-4 at 106,000 columns, 2.0e-4 at 262,144);
- elementwise terms, regularization and the update rules: rtol 1e-6,
  atol 1e-7 (the same float32 operations, at most an ulp apart where the
  two frameworks round a Python scalar differently);
- whole fits: rtol 1e-5, atol 1e-7 on coefficients and the loss. Up to 70
  rounds of sums reassociated by another matrix-vector product differ by
  less than 1e-6 relative on these inputs; the bound leaves a factor of 10
  for other BLAS builds, and is ten times tighter than the 1e-4 that float32
  reassociation over a long fit could ask for. The same bound holds the
  fit at 262,144 columns, whose three rounds of dots over that many terms
  move its coefficients (up to 4e-4) by about 1e-10.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import scipy.sparse
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_opt
from flink_ml_tpu.ops import regularization as jax_reg
from flink_ml_tpu.ops.pallas_kernels import sgd_batch_terms as pallas_terms
from flink_ml_tpu.parallel import create_mesh
from flink_ml_tpu_torch.observability.health import NonFiniteState
from flink_ml_tpu_torch.ops import kernels, losses, optimizer, regularization

LOSSES = ["logistic", "hinge", "least_square"]
FIT_RTOL, FIT_ATOL = 1e-5, 1e-7
EW_RTOL, EW_ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def mesh1():
    return create_mesh(devices=jax.devices()[:1])


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _data(seed, n, d, labels="binary"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    truth = rng.normal(size=d)
    if labels == "binary":
        y = (x @ truth + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    else:
        y = (x @ truth + 0.1 * rng.normal(size=n)).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("start,clip", [(0, 0), (16, 0), (48, 5)])
def test_plain_batch_terms_match_the_pallas_kernel(loss_name, start, clip):
    rng = np.random.default_rng(7)
    n, d, lb, tile = 64, 5, 16, 8
    xl = rng.normal(size=(n, d)).astype(np.float32)
    yl = (rng.random(n) > 0.5).astype(np.float32)
    wl = (rng.random(n) + 0.5).astype(np.float32)
    coeffs = rng.normal(size=d).astype(np.float32)
    want = np.asarray(pallas_terms(xl, yl, wl, coeffs, start, clip, lb, tile,
                                   loss_name, interpret=True))
    got = kernels.sgd_batch_terms(_t(xl), _t(yl), _t(wl), _t(coeffs), start,
                                  clip, lb, loss_name)
    assert got.dtype == torch.float32 and got.shape == (d + 2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("d", [513, 1_500])
def test_wide_plain_batch_terms_match_the_pallas_kernel(loss_name, d):
    """Rows wider than the register instance takes (the staged instance's
    widths on the card): a clipped window at a tile-aligned start."""
    rng = np.random.default_rng(d)
    n, lb, tile, start, clip = 64, 16, 8, 24, 3
    xl = rng.normal(size=(n, d)).astype(np.float32)
    yl = (rng.random(n) > 0.5).astype(np.float32)
    wl = (rng.random(n) + 0.5).astype(np.float32)
    coeffs = (rng.normal(size=d) / np.sqrt(d)).astype(np.float32)
    want = np.asarray(pallas_terms(xl, yl, wl, coeffs, start, clip, lb, tile,
                                   loss_name, interpret=True))
    got = kernels.sgd_batch_terms(_t(xl), _t(yl), _t(wl), _t(coeffs), start,
                                  clip, lb, loss_name)
    assert got.dtype == torch.float32 and got.shape == (d + 2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("d", [13_210, 16_000, 106_000, 262_144])
def test_cluster_width_plain_batch_terms_match_the_pallas_kernel(loss_name,
                                                                 d):
    """Rows past the staged instance's widths (the cluster instance's on
    the card, and past 105,568 columns the grid instance's): 48 seeded
    rows, a clipped window of 32 at a tile-aligned start, against the
    Pallas kernel in interpret mode (rtol 2e-5, atol 5e-5 up to 16,000
    columns: dots of d terms with margins near 1, each about 1.6e-6 off,
    sums of 32 rows; wider, atol 5e-5·√(d / 16,000): the dots' errors grow
    as √d; the module docstring)."""
    rng = np.random.default_rng(d + 1)
    n, lb, tile, start, clip = 48, 32, 8, 8, 3
    xl = rng.normal(size=(n, d)).astype(np.float32)
    yl = (rng.random(n) > 0.5).astype(np.float32)
    wl = (rng.random(n) + 0.5).astype(np.float32)
    coeffs = (rng.normal(size=d) / np.sqrt(d)).astype(np.float32)
    want = np.asarray(pallas_terms(xl, yl, wl, coeffs, start, clip, lb, tile,
                                   loss_name, interpret=True))
    got = kernels.sgd_batch_terms(_t(xl), _t(yl), _t(wl), _t(coeffs), start,
                                  clip, lb, loss_name)
    assert got.dtype == torch.float32 and got.shape == (d + 2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=5e-5 * max(1.0, (d / 16_000) ** 0.5))


@pytest.mark.parametrize("loss_name", LOSSES)
def test_batch_terms_edges(loss_name):
    x, y, w = _data(3, 40, 7)
    c = np.random.default_rng(4).normal(size=7).astype(np.float32)
    args = (_t(x), _t(y), _t(w), _t(c))
    # lb = 0 gives zeros; a full clip weighs every row 0
    empty = kernels.sgd_batch_terms(*args, 10, 0, 0, loss_name)
    assert not empty.any() and empty.shape == (9,)
    clipped = kernels.sgd_batch_terms(*args, 5, 20, 20, loss_name)
    assert not clipped.any()
    for start, clip, lb in [(-1, 0, 5), (38, 0, 5), (0, 6, 5), (0, 0, -1)]:
        with pytest.raises(ValueError, match="window"):
            kernels.sgd_batch_terms(*args, start, clip, lb, loss_name)
    with pytest.raises(ValueError, match="unknown loss"):
        kernels.sgd_batch_terms(*args, 0, 0, 5, "huber")
    with pytest.raises(TypeError, match="float32"):
        kernels.sgd_batch_terms(args[0].double(), *args[1:], 0, 0, 5, loss_name)


@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_terms_match_jax(loss_name, scale):
    rng = np.random.default_rng(11)
    dots = (rng.normal(size=64) * scale).astype(np.float32)
    dots[:4] = [100.0, -100.0, 95.0, -95.0]  # |margin| ~ 100: exp overflows
    labels = (rng.random(64) > 0.5).astype(np.float32)
    weights = (rng.random(64) + 0.5).astype(np.float32)
    weights[5] = 0.0
    want_loss, want_mult = jax_losses.LossFunc.by_name(loss_name).terms(
        jnp.asarray(dots), jnp.asarray(labels), jnp.asarray(weights))
    got_loss, got_mult = losses.LossFunc.by_name(loss_name).terms(
        _t(dots), _t(labels), _t(weights))
    assert got_mult.dtype == torch.float32
    assert np.isfinite(got_loss.item()) and torch.isfinite(got_mult).all()
    np.testing.assert_allclose(got_mult.numpy(), np.asarray(want_mult),
                               rtol=EW_RTOL, atol=EW_ATOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)


def test_loss_and_gradient_and_names():
    x, y, w = _data(5, 30, 4)
    c = np.random.default_rng(6).normal(size=4).astype(np.float32)
    for name in LOSSES:
        got_loss, got_grad = losses.LossFunc.by_name(name).loss_and_gradient(
            _t(c), _t(x), _t(y), _t(w))
        want_loss, want_grad = jax_losses.LossFunc.by_name(
            name).loss_and_gradient(jnp.asarray(c), jnp.asarray(x),
                                    jnp.asarray(y), jnp.asarray(w))
        np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.LossFunc.by_name("huber")


@pytest.mark.parametrize("reg,elastic_net", [
    (0.0, 0.0), (0.1, 0.0), (0.1, 1.0), (0.1, 0.5)])
def test_regularize_matches_jax(reg, elastic_net):
    coeffs = np.random.default_rng(8).normal(size=12).astype(np.float32)
    coeffs[[2, 7]] = 0.0  # sign(0) = 0: exact zeros are skipped
    want_new, want_loss = jax_reg.regularize(jnp.asarray(coeffs), reg,
                                             elastic_net, 0.1)
    got_new, got_loss = regularization.regularize(_t(coeffs), reg,
                                                  elastic_net, 0.1)
    assert got_new.dtype == torch.float32 and got_loss.dtype == torch.float32
    np.testing.assert_allclose(got_new.numpy(), np.asarray(want_new),
                               rtol=EW_RTOL, atol=EW_ATOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss),
                               rtol=EW_RTOL, atol=EW_ATOL)
    if elastic_net > 0:
        assert got_new[2].item() == 0.0 and got_new[7].item() == 0.0


@pytest.mark.parametrize("method", ["sgd", "momentum", "adam"])
def test_update_rule_matches_jax_over_three_steps(method):
    rng = np.random.default_rng(9)
    prm = dict(learning_rate=0.05, method=method, momentum=0.8)
    jrule = jax_opt._update_rule(jax_opt.SGDParams(**prm))
    trule = optimizer._update_rule(optimizer.SGDParams(**prm))
    d = 6
    jw, tw = jnp.zeros(d, jnp.float32), torch.zeros(d)
    jopt = tuple(jnp.zeros(d, jnp.float32)
                 for _ in range(jax_opt._OPT_VECTORS[method]))
    if method == "adam":
        jopt += (jnp.asarray(0.0, jnp.float32),)
    topt = optimizer._init_opt(optimizer.SGDParams(**prm), d,
                               torch.device("cpu"))
    assert len(topt) == len(jopt)
    for _ in range(3):
        grad = rng.normal(size=d).astype(np.float32) * 10
        total = np.float32(rng.random() * 20 + 1)
        jw, jopt = jrule(jnp.asarray(grad), jnp.asarray(total), jw, jopt)
        tw, topt = trule(_t(grad), torch.tensor(total), tw, topt)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                   rtol=EW_RTOL, atol=EW_ATOL)
        for got, want in zip(topt, jopt):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=EW_RTOL, atol=EW_ATOL)
    with pytest.raises(ValueError, match="method"):
        optimizer._update_rule(optimizer.SGDParams(method="lbfgs"))


def test_zero_weight_round_leaves_coefficients_and_moments():
    prm = optimizer.SGDParams(method="momentum", reg=0.1, elastic_net=0.5)
    rule = optimizer._update_rule(prm)
    coeffs = torch.tensor([0.5, -1.0, 0.0])
    opt = (torch.tensor([0.1, 0.2, 0.3]),)
    packed = torch.tensor([3.0, -2.0, 1.0, 0.0, 5.0])
    got, got_opt, mean_loss = optimizer._apply_packed(prm, rule, coeffs, opt,
                                                      packed)
    assert torch.equal(got, coeffs) and torch.equal(got_opt[0], opt[0])
    # no weight: the loss over the 1e-30 floor, as in the JAX package
    np.testing.assert_allclose(mean_loss.item(), 5e30, rtol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 10, 64, 100, 101])
@pytest.mark.parametrize("lb", [1, 3, 10, 32, 100])
@pytest.mark.parametrize("max_iter", [1, 5, 40])
def test_static_batch_schedule_matches_jax(n, lb, max_iter):
    """The port's schedule on one shard (``ShardSchedule``) takes the JAX
    package's static windows: (start, first valid row), every window lb
    rows long."""
    lb = min(lb, n)
    sched = optimizer.ShardSchedule(lb, 1, n, [n])
    windows = sched.windows((0,), [0], max_iter)
    assert all(w[0][2] == lb for w in windows)
    got = [(start, clip) for ((start, clip, _),) in windows]
    assert got == jax_opt._static_batch_schedule(n, lb, max_iter)
    assert all(0 <= s <= n - lb and 0 <= c <= lb for s, c in got)


def _jax_fit(mesh, loss_name, prm, x, y, w):
    sgd = jax_opt.SGD(jax_opt.SGDParams(**prm))
    coeffs, loss = sgd.optimize(jax_losses.LossFunc.by_name(loss_name),
                                np.zeros(x.shape[1], np.float32), x, y, w,
                                mesh=mesh)
    return coeffs, loss, sgd.last_execution_path


def _port_fit(loss_name, prm, x, y, w):
    sgd = optimizer.SGD(optimizer.SGDParams(**prm))
    coeffs, loss = sgd.optimize(losses.LossFunc.by_name(loss_name),
                                np.zeros(x.shape[1], np.float32), x, y, w,
                                device="cpu")
    assert sgd.last_execution_path == "torch-sgd"
    assert coeffs.dtype == np.float64 and coeffs.shape == (x.shape[1],)
    return coeffs, loss


@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("method,reg,elastic_net", [
    ("sgd", 0.0, 0.0), ("sgd", 0.05, 0.5), ("momentum", 0.05, 0.0),
    ("momentum", 0.05, 1.0), ("adam", 0.0, 0.0), ("adam", 0.02, 0.5)])
def test_sgd_fit_matches_jax(mesh1, loss_name, method, reg, elastic_net):
    x, y, w = _data(21, 230, 6,
                    labels="real" if loss_name == "least_square" else "binary")
    prm = dict(learning_rate=0.05, global_batch_size=64, max_iter=12, tol=0.0,
               reg=reg, elastic_net=elastic_net, method=method)
    want, want_loss, path = _jax_fit(mesh1, loss_name, prm, x, y, w)
    assert path == "xla-unrolled"
    got, got_loss = _port_fit(loss_name, prm, x, y, w)
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_allclose(got_loss, want_loss, rtol=FIT_RTOL,
                               atol=FIT_ATOL)


@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("case", ["while-70", "weights-none", "gb>n", "gb=n"])
def test_sgd_fit_shapes_match_jax(mesh1, loss_name, case):
    n = 150 if case != "while-70" else 203
    x, y, w = _data(31, n, 5,
                    labels="real" if loss_name == "least_square" else "binary")
    prm = dict(learning_rate=0.1, global_batch_size=40, max_iter=9, tol=0.0)
    if case == "while-70":  # past 64 rounds the JAX package runs its while loop
        prm["max_iter"] = 70
    elif case == "weights-none":
        w = None
    elif case == "gb>n":
        prm["global_batch_size"] = 500
    else:
        prm["global_batch_size"] = n
    want, want_loss, path = _jax_fit(mesh1, loss_name, prm, x, y, w)
    assert path == ("xla-while" if case == "while-70" else "xla-unrolled")
    got, got_loss = _port_fit(loss_name, prm, x, y, w)
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_allclose(got_loss, want_loss, rtol=FIT_RTOL,
                               atol=FIT_ATOL)


@pytest.mark.parametrize("loss_name", LOSSES)
def test_tol_stops_at_the_same_round_as_jax(mesh1, loss_name):
    x, y, w = _data(41, 120, 4,
                    labels="real" if loss_name == "least_square" else "binary")
    base = dict(learning_rate=0.1, global_batch_size=30, tol=0.0)
    # the data loss of every round of a long fit; tol between round k's
    # loss and the smallest loss before it makes round k the stopping round
    hist = []
    for rounds in range(1, 9):
        hist.append(_jax_fit(mesh1, loss_name, dict(base, max_iter=rounds),
                             x, y, w)[1])
    k = int(np.argmin(hist[2:])) + 2
    earlier = min(hist[:k])
    if hist[k] >= earlier:
        pytest.fail(f"no round of {hist} falls below all earlier ones")
    tol = float(np.float32((hist[k] + earlier) / 2))
    prm = dict(base, max_iter=20, tol=tol)
    want, want_loss, _ = _jax_fit(mesh1, loss_name, prm, x, y, w)
    np.testing.assert_allclose(want_loss, hist[k], rtol=1e-6)
    coeffs = torch.zeros(4)
    got_coeffs, got_loss, epoch = optimizer.sgd_rounds(
        kernels.sgd_batch_terms, loss_name, optimizer.SGDParams(**prm),
        _t(x), _t(y), _t(w), coeffs)
    assert int(epoch) == k + 1
    np.testing.assert_allclose(got_loss.item(), want_loss, rtol=FIT_RTOL,
                               atol=FIT_ATOL)
    np.testing.assert_allclose(got_coeffs.numpy(), want, rtol=FIT_RTOL,
                               atol=FIT_ATOL)


def test_sgd_fit_keeps_float32_and_device_tensors():
    x, y, w = _data(51, 80, 3)
    xt, yt = _t(x), _t(y)
    sgd = optimizer.SGD(optimizer.SGDParams(max_iter=3, global_batch_size=16))
    coeffs, loss = sgd.optimize(losses.BinaryLogisticLoss(), np.zeros(3), xt,
                                yt, None, device="cpu")
    assert isinstance(loss, float) and coeffs.dtype == np.float64
    # a CSR matrix takes the segment-sum rounds (optimize_csr), float32 on
    # the device as the dense fit is
    csr = scipy.sparse.csr_matrix(x)
    csr_coeffs, csr_loss = sgd.optimize(losses.BinaryLogisticLoss(),
                                        np.zeros(3), csr, y, None,
                                        device="cpu")
    assert sgd.last_execution_path == "torch-csr"
    assert isinstance(csr_loss, float) and csr_coeffs.dtype == np.float64
    np.testing.assert_allclose(csr_coeffs, coeffs, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="coefficients"):
        sgd.optimize(losses.BinaryLogisticLoss(), np.zeros(4), x, y, None,
                     device="cpu")
    # max_iter = 0 runs no round: the loss stays inf and the guard raises,
    # as the JAX package's does
    empty = optimizer.SGD(optimizer.SGDParams(max_iter=0))
    with pytest.raises(NonFiniteState):
        empty.optimize(losses.BinaryLogisticLoss(), np.zeros(3), x, y, None,
                       device="cpu")


def test_the_sgd_layout_takes_any_width():
    """No width is refused: rows of up to 512 columns take the register
    instance (V = ⌈d / 128⌉ float4s a lane) on a persistent grid, wider
    rows the staged one while its ring fits a block (whole rows, dc = d),
    wider rows the cluster one while a cluster of 8 CTAs holds them (each
    CTA a slice of dc columns), wider rows the grid one while a grid of
    132 CTAs (an H100's, one an SM) holds them (each CTA a slice of dc
    columns, one partial row), wider still the two-pass set (segments of
    4,096 columns over bands of 32 rows, one partial row)."""
    for d in (1, 7, 100, 128, 129, 256, 300, 511, 512):
        plan = kernels._sgd_plan(100_000, d, 396, sms=132)
        assert plan.instance == "registers" and plan.v == -(-d // 128)
        assert plan.blocks == 396 and plan.segments == 0
    # 16 rows a warp
    assert kernels._sgd_plan(1_000, 100, 396, sms=132).blocks == 8
    for d in (513, 1_500, 6_001, 13_209):
        plan = kernels._sgd_plan(100_000, d, 792, sms=132)
        rows, smem = kernels._sgd_staged_layout(d)
        assert plan.instance == "staged" and plan.v == 0 and plan.dc == d
        assert (plan.rows, plan.smem, plan.segments) == (rows, smem, 0)
        assert 1 <= rows <= 16 and smem <= kernels.SMEM_BLOCK_BYTES
        assert plan.blocks <= 792
    for d in (13_210, 16_000, 10 ** 5, 105_568):
        plan = kernels._sgd_plan(100_000, d, 66, sms=132)
        c = kernels._sgd_cluster_size(d)
        rows, smem = kernels._sgd_cluster_layout(plan.dc)
        assert plan.instance == "cluster" and plan.v == 0 and plan.cluster == c
        assert plan.dc == kernels._sgd_cluster_slice(d, c) and plan.dc % 4 == 0
        assert (c - 1) * plan.dc < d <= c * plan.dc
        assert (plan.rows, plan.smem, plan.segments) == (rows, smem, 0)
        assert 1 <= rows <= 16 and smem <= kernels.SMEM_BLOCK_BYTES
        assert plan.blocks <= 66
    for d in (105_569, 10 ** 6, 1_959_936):
        plan = kernels._sgd_plan(100_000, d, 132, sms=132)
        rows, smem = kernels._sgd_grid_layout(d, 132)
        assert plan.instance == "grid" and plan.v == 0 and plan.grid == 132
        assert plan.dc == kernels._sgd_cluster_slice(d, 132)
        assert plan.dc % 4 == 0 and 131 * plan.dc < d <= 132 * plan.dc
        assert (plan.rows, plan.smem, plan.blocks) == (rows, smem, 1)
        assert 1 <= rows <= 32 and smem <= kernels.SMEM_BLOCK_BYTES
    for d in (1_959_937, 10 ** 7):
        plan = kernels._sgd_plan(100_000, d, 792, sms=132)
        assert plan.instance == "twopass" and plan.v == 0
        assert (plan.rows, plan.dc, plan.smem) == (32, 4_096, 0)
        assert plan.segments == -(-d // 4_096)
        assert (plan.blocks, plan.cluster, plan.grid) == (1, 0, 0)


@pytest.mark.parametrize("d", [7, 100, 512, 513, 2_000, 6_001, 20_000,
                               60_001, 120_000, 2_000_000])
@pytest.mark.parametrize("lb", [1, 31, 100, 100_003])
def test_the_sgd_plan_covers_the_window_once(lb, d):
    """Stage 1's workers (warps of the register instance, blocks of the
    staged one, clusters of the cluster one, the one grid of the grid one,
    the one partial row of the two-pass set) take contiguous runs that
    cover [0, lb) once, in order; the register, staged and cluster
    instances' runs differ by at most one row, and their grids give every
    warp SGD_WARP_ROWS rows (every staged block or cluster
    SGD_BLOCK_STAGES stages) or fill the card; the grid instance runs every
    CTA the card holds (132 here) at any window."""
    resident = 132 if 105_568 < d <= 1_959_936 else 396
    plan = kernels._sgd_plan(lb, d, resident, sms=132)
    assert plan.instance == ("registers" if d <= 512 else
                             "staged" if d <= 13_209 else
                             "cluster" if d <= 105_568 else
                             "grid" if d <= 1_959_936 else "twopass")
    assert 1 <= plan.blocks <= resident
    runs = kernels.sgd_runs(plan, lb)
    assert runs[0][0] == 0 and runs[-1][1] == lb
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    lengths = [r1 - r0 for r0, r1 in runs]
    if plan.instance == "grid":
        assert runs == [(0, lb)] and plan.blocks == 1
        assert plan.grid == plan.resident == resident
    elif plan.instance == "twopass":
        assert runs == [(0, lb)] and plan.blocks == 1 and plan.grid == 0
    elif plan.instance == "registers":
        assert len(runs) == plan.blocks * kernels.SGD_WARPS
        assert max(lengths) - min(lengths) <= 1
        assert (plan.blocks == resident or plan.blocks == -(-lb // (
            kernels.SGD_WARPS * kernels.SGD_WARP_ROWS)))
    else:
        assert plan.instance in ("staged", "cluster")
        assert len(runs) == plan.blocks and min(lengths) >= 1
        assert max(lengths) - min(lengths) <= 1
        assert (plan.blocks == resident or plan.blocks == -(-lb // (
            kernels.SGD_BLOCK_STAGES * plan.rows)))


@pytest.mark.parametrize("d,instance,nreg,rows", [
    (512, "registers", 0, 0), (513, "staged", 4, 15), (1_024, "staged", 4, 8),
    (1_025, "staged", 8, 7), (2_000, "staged", 8, 4), (2_048, "staged", 8, 4),
    (2_049, "staged", 16, 3), (4_096, "staged", 16, 2),
    (4_097, "staged", 16, 1), (8_192, "staged", 16, 1),
    (8_193, "staged", 16, 1), (13_209, "staged", 16, 1),
    (13_210, "cluster", 16, 1), (105_665, "grid", 4, 23),
    (1_959_936, "grid", 16, 1), (1_959_937, "twopass", 0, 32)])
def test_the_sgd_plan_routes_each_width(d, instance, nreg, rows):
    """Which stage-1 instance each width takes, at the edges: the staged
    instance's columns a thread keeps in registers (4, 8, 16: past 4,096
    columns the rest sit in shared memory), its rows a stage (32 KB
    of x, 16 rows at most, one row past 8,192 floats), and the widest row
    whose three-stage ring fits a block's 232,448 bytes; past it the
    cluster instance (the next test), past a cluster of 8 the grid one
    (over an H100's 132 CTAs; the grid tests below), past a grid of 132
    the two-pass set (bands of 32 rows; its tests below)."""
    plan = kernels._sgd_plan(100_000, d, 264, sms=132)
    assert plan.instance == instance and plan.rows == rows
    if instance == "cluster":
        assert kernels._sgd_nreg(plan.dc) == nreg and plan.cluster == 2
    if instance == "grid":
        assert kernels._sgd_grid_nreg(plan.dc) == nreg and plan.grid == 132
    if instance != "staged":
        return
    assert kernels._sgd_nreg(d) == nreg
    stage = (rows * d + 6) // 4 * 4  # up to 3 floats before the first row
    over = max(0, -(-d // 256) * 256 - 256 * nreg)
    floats = 3 * stage + 6 * rows + -(-rows // 4) * 4 * 8 + 3 * rows + 2 * over
    assert plan.smem == 4 * floats <= kernels.SMEM_BLOCK_BYTES
    assert plan.dc == d and plan.blocks == 264


@pytest.mark.parametrize("d,c,ds", [
    (13_210, 2, 6_608), (14_784, 2, 7_392), (14_785, 4, 3_700),
    (16_000, 4, 4_000), (29_568, 4, 7_392), (29_569, 8, 3_700),
    (59_136, 8, 7_392), (59_137, 8, 7_396), (100_000, 8, 12_500),
    (105_568, 8, 13_196), (105_569, None, 0)])
def test_the_cluster_plan_routes_each_width(d, c, ds):
    """Past the staged widths each width takes the smallest cluster (2, 4
    or 8 CTAs) whose CTAs, each a slice of ⌈d / c⌉ columns rounded up to
    4, fit two an SM (a three-stage ring beside the warps' sums of two
    stages, in at most half the SM's shared memory); where none does, the
    smallest whose CTA fits at all. At the edges: two an SM up to a slice
    of 7,392 columns, one up to 13,196, and past a cluster of 8 the grid
    instance."""
    assert kernels._sgd_cluster_size(d) == c
    plan = kernels._sgd_plan(100_000, d, 66, sms=132)
    if c is None:
        assert plan.instance == "grid" and plan.cluster == 0
        assert kernels._sgd_cluster_layout(
            kernels._sgd_cluster_slice(d, 8)) is None
        return
    assert plan.instance == "cluster" and plan.cluster == c and plan.dc == ds
    rows = max(1, min(16, 8192 // ds))
    pitch = (ds + 6) // 4 * 4  # up to 3 floats before a row's slice
    over = max(0, -(-ds // 256) * 256 - 256 * kernels._sgd_nreg(ds))
    floats = (3 * rows * pitch + 6 + 6 * rows + 2 * -(-rows // 4) * 4 * 8
              + 3 * rows + 2 * over)
    assert plan.rows == rows and plan.smem == 4 * floats
    assert plan.smem <= kernels.SMEM_BLOCK_BYTES and plan.blocks == 66
    two = kernels.SGD_TWO_PER_SM_BYTES
    assert two == (228 * 1024 - 2 * 1024) // 2
    # no smaller cluster takes the row two an SM (or at all, where this
    # one does not fit two)
    for smaller in (s for s in kernels.SGD_CLUSTER_SIZES if s < c):
        layout = kernels._sgd_cluster_layout(kernels._sgd_cluster_slice(
            d, smaller))
        assert layout is None or (plan.smem <= two < layout[1])
    if plan.smem > two:
        assert c == 8
    assert kernels._sgd_cluster_layout(13_196) is not None
    assert kernels._sgd_cluster_layout(13_200) is None


@pytest.mark.parametrize("c", [2, 4, 8])
@pytest.mark.parametrize("lb", [1, 7, 4_999, 100_003])
@pytest.mark.parametrize("d", [16_000, 50_001])
def test_the_cluster_plan_covers_the_window_once(d, lb, c):
    """Any cluster size the card check runs by hand: the clusters' runs
    cover [0, lb) once, in order, at most one row apart, as many clusters
    as give each SGD_BLOCK_STAGES stages or as the card holds; each CTA's
    slice of the row is nonempty and the slices cover [0, d)."""
    ds = kernels._sgd_cluster_slice(d, c)
    if kernels._sgd_cluster_layout(ds) is None:
        with pytest.raises(ValueError, match="no cluster"):
            kernels._sgd_cluster_plan(lb, d, 66, 1, c)
        return
    plan = kernels._sgd_cluster_plan(lb, d, 66, 1, c)
    assert plan.instance == "cluster" and plan.cluster == c and plan.vec4 == 1
    runs = kernels.sgd_runs(plan, lb)
    assert len(runs) == plan.blocks and runs[0][0] == 0 and runs[-1][1] == lb
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    lengths = [r1 - r0 for r0, r1 in runs]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    assert plan.blocks == min(66, -(-lb // (kernels.SGD_BLOCK_STAGES
                                            * plan.rows)))
    slices = [(r * ds, min(d, (r + 1) * ds)) for r in range(c)]
    assert all(a < b for a, b in slices) and slices[-1][1] == d


@pytest.mark.parametrize("d,ds,nreg,rows", [
    (105_569, 800, 4, 23), (106_000, 804, 4, 23), (131_072, 996, 4, 19),
    (150_001, 1_140, 4, 16), (262_144, 1_988, 4, 9), (270_336, 2_048, 4, 9),
    (270_337, 2_052, 8, 9), (540_672, 4_096, 8, 4), (540_673, 4_100, 16, 4),
    (1_048_576, 7_944, 16, 2), (1_081_345, 8_196, 16, 2),
    (1_959_936, 14_848, 16, 1), (1_959_937, None, 0, 0)])
def test_the_grid_plan_routes_each_width(d, ds, nreg, rows):
    """Past a cluster of 8 each width takes the grid instance over an
    H100's 132 CTAs while one row's slice (⌈d / 132⌉ rounded up to 4)
    fits a CTA: a three-stage ring of the most rows (up to 32) that fit
    the block's 232,448 bytes beside the stages' mbarriers, labels and
    weights, the 16 warps' dot sums, the multipliers, the row slots' sums
    and the sums and coefficients of the columns past a thread's 4, 8 or
    16 registers (512 threads); past 1,959,936 columns (a slice of 14,848)
    the two-pass set. Every width's layout takes more than half an SM's shared
    memory, so the card holds one CTA an SM and the grid's 132 CTAs are
    all of them; every CTA gets columns."""
    plan = kernels._sgd_plan(3_000, d, 132, sms=132)
    if ds is None:
        assert kernels._sgd_grid_layout(d, 132) is None
        assert plan.instance == "twopass" and plan.grid == 0
        assert plan.segments == kernels._sgd_twopass_segments(d, 0)
        return
    assert plan.instance == "grid" and plan.dc == ds and plan.rows == rows
    assert kernels._sgd_grid_nreg(ds) == nreg
    assert (plan.grid, plan.resident, plan.blocks, plan.cluster) == (
        132, 132, 1, 0)
    pitch = (ds + 6) // 4 * 4  # up to 3 floats before a row's slice
    over = max(0, -(-ds // 512) * 512 - 512 * nreg)

    def floats(r):
        return (3 * r * pitch + 6 + 6 * r + -(-r // 4) * 4 * 16 + 3 * r
                + 2 * over)
    assert plan.smem == 4 * floats(rows) <= kernels.SMEM_BLOCK_BYTES
    assert rows == 32 or 4 * floats(rows + 1) > kernels.SMEM_BLOCK_BYTES
    assert plan.smem > kernels.SGD_TWO_PER_SM_BYTES  # one CTA an SM
    assert 131 * ds < d <= 132 * ds
    if ds <= kernels.SGD_GRID_ROW_COLS:  # the warps' column sums fit the ring
        assert 3 * rows * pitch >= 16 * ds


@pytest.mark.parametrize("ctas", [114, 132])
@pytest.mark.parametrize("lb", [1, 7, 3_019, 100_003])
@pytest.mark.parametrize("d", [105_569, 262_144, 1_048_576])
def test_the_grid_plan_covers_the_window_once(d, lb, ctas):
    """The grid instance at any window runs one worker over [0, lb) and
    all the CTAs the card holds (an H100 SXM's 132 or a PCIe card's 114);
    the CTAs' slices are nonempty, 4-column aligned and cover [0, d)."""
    plan = kernels._sgd_plan(lb, d, ctas, 1, sms=ctas)
    assert plan.instance == "grid" and plan.grid == ctas and plan.vec4 == 1
    assert kernels.sgd_runs(plan, lb) == [(0, lb)] and plan.blocks == 1
    slices = [(g * plan.dc, min(d, (g + 1) * plan.dc)) for g in range(ctas)]
    assert all(a < b for a, b in slices) and slices[-1][1] == d
    assert all(a % 4 == 0 for a, _ in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    with pytest.raises(ValueError, match="no grid"):
        kernels._sgd_grid_plan(d, 10 ** 6)


@pytest.mark.parametrize("vec4", [0, 1])
@pytest.mark.parametrize("lb", [1, 76, 1_250, 100_003])
@pytest.mark.parametrize("d", [1_959_937, 2_097_152, 2_500_001, 10 ** 7])
def test_the_twopass_plan_covers_every_column_and_row(d, lb, vec4):
    """Past the grid's widths the two-pass set: every column has exactly
    one owner CTA of mult · x (slices of 512 at these widths, nonempty, in
    order); every
    row of the window is read in the same S segments of 1,024 float4s (by
    16 bytes from the aligned address at or before the row where vec4: o =
    (row · d) mod 4 floats before it; by 4 bytes in fours of columns
    else), the widest row's last segment nonempty; the bands of 32 rows
    cover the window, the last nonempty; the scratch is lb × S partial dots,
    then lb multipliers and the weight and loss sums of the terms CTAs (8
    rows each, the last nonempty)."""
    plan = kernels._sgd_plan(lb, d, 132, vec4, sms=132)
    assert plan.instance == "twopass" and plan.vec4 == vec4
    grids = kernels.sgd_twopass_grids(plan, lb, d)
    count, cols = grids["owners"]
    owners = [(c, min(d, c + cols)) for c in range(0, count * cols, cols)]
    assert owners[0][0] == 0 and owners[-1][1] == d
    assert all(a < b <= a + 512 for a, b in owners)
    assert all(b - a == 512 for a, b in owners[:-1])
    assert all(a[1] == b[0] for a, b in zip(owners, owners[1:]))
    segments, bands = grids["dots"]
    assert segments == plan.segments and plan.dc == 4 * 1_024
    shifts = {(r * d) % 4 for r in range(min(lb, 4))} if vec4 else {0}
    widest = max((o + d + 3) // 4 for o in shifts)  # float4s of a row
    assert (segments - 1) * 1_024 < widest <= segments * 1_024
    assert (bands - 1) * plan.rows < lb <= bands * plan.rows
    assert plan.rows == 32 and bands <= kernels.SGD_TWOPASS_MAX_BANDS
    terms = grids["terms"]
    assert (terms - 1) * 8 < lb <= terms * 8
    assert grids["scratch"] - lb - 2 * terms == lb * segments
    assert kernels.sgd_runs(plan, lb) == [(0, lb)] and plan.blocks == 1


@pytest.mark.parametrize("d,cols", [
    (513, 128), (106_000, 128), (131_071, 128), (131_072, 256),
    (262_143, 256), (262_144, 512), (1_048_576, 512)])
def test_the_twopass_owners_narrow_on_narrow_rows(d, cols):
    """Run by hand at narrower rows, the set's owner CTAs keep fewer
    columns (128 threads from 262,144 columns, 64 from 131,072, 32
    below), so the card still gets at least 512 of them from 65,536
    columns; the slices cover [0, d) once."""
    plan = kernels._sgd_twopass_plan(d, 132, 1)
    count, width = kernels.sgd_twopass_grids(plan, 3_019, d)["owners"]
    owners = [(c, min(d, c + width)) for c in range(0, count * width, width)]
    assert 4 * plan.owner == cols == width
    assert owners[0][0] == 0 and owners[-1][1] == d
    assert all(b - a == cols for a, b in owners[:-1])
    assert all(a[1] == b[0] for a, b in zip(owners, owners[1:]))
    assert len(owners) >= 512 or d < 65_536


@pytest.mark.parametrize("d", [1_000_000, 1_692_672, 1_692_673, 1_959_936,
                               1_959_937])
def test_a_card_with_fewer_sms_hands_over_to_twopass_sooner(d):
    """The grid instance runs one CTA an SM, so on a card of 114 SMs its
    range ends at 1,692,672 columns, not 1,959,936: past that the two-pass
    set takes over, exactly where no grid layout fits."""
    for sms in (114, 132):
        plan = kernels._sgd_plan(1_250, d, sms, 1, sms=sms)
        grid = kernels._sgd_grid_layout(d, sms)
        assert plan.instance == ("grid" if grid else "twopass"), (d, sms)
        assert kernels._sgd_instance(d, sms) == plan.instance
        assert plan.grid == (sms if grid else 0)
    assert (kernels._sgd_grid_layout(d, 114) is None) == (d > 1_692_672)
    assert (kernels._sgd_grid_layout(d, 132) is None) == (d > 1_959_936)


def test_the_staged_instance_reads_any_width_by_16_bytes(monkeypatch):
    """The card plan reads rows by 16 bytes from an aligned x at a width
    that is a multiple of 4, and at any width the staged, cluster, grid and
    two-pass instances take (a stage is one contiguous run, a row's slice
    or segment too, read from the aligned address at or before it); never
    from an unaligned x."""
    monkeypatch.setattr(kernels, "_device_index", lambda t: 0)
    monkeypatch.setattr(kernels, "_card_sms", lambda i: 132)
    monkeypatch.setattr(kernels, "_sgd_resident_blocks", lambda *a: 264)
    monkeypatch.setattr(kernels, "_sgd_resident_clusters", lambda *a: 66)
    monkeypatch.setattr(kernels, "_sgd_resident_grid", lambda *a: 132)
    kernels._sgd_plan_on.cache_clear()
    try:
        for d, vec4 in [(7, 0), (100, 1), (513, 1), (514, 1), (6_001, 1),
                        (13_210, 1), (13_212, 1), (50_001, 1),
                        (105_665, 1), (105_668, 1), (1_959_937, 1),
                        (1_959_940, 1), (2_000_001, 1), (2_097_152, 1)]:
            x = torch.zeros(3 * d + 1)
            assert x.data_ptr() % 16 == 0
            plan = kernels._sgd_card_plan(x[:3 * d].view(3, d), 2, "hinge")
            assert plan.vec4 == vec4, d
            shifted = x[1:].view(3, d)  # 4 bytes off
            assert kernels._sgd_card_plan(shifted, 2, "hinge").vec4 == 0
    finally:
        kernels._sgd_plan_on.cache_clear()


def test_a_wide_row_on_the_card_launches_the_kernel(monkeypatch):
    """A CUDA tensor of any width reaches the kernel launch every round and
    never the plain version (every tensor counts as a CUDA tensor here);
    the round's terms are the last row of the launch's workspace, and no
    second stage is launched from Python."""
    launched = []

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    def launch(xl, yl, wl, coeffs, start, clip, lb, loss_name):
        launched.append((xl.shape[1], start, clip, lb))
        return torch.zeros((2, coeffs.shape[0] + 2))

    monkeypatch.setattr(kernels, "_is_cuda", lambda t: True)
    monkeypatch.setattr(kernels, "sgd_batch_terms_plain", no_plain)
    monkeypatch.setattr(kernels, "reduce_partials_plain", no_plain)
    monkeypatch.setattr(kernels, "_launch_sgd_terms", launch)
    monkeypatch.setattr(kernels, "_launch_reduce", no_plain)
    kernels.reset_launch_counts()
    wide = 10 ** 4
    x, y, _ = _data(61, 50, wide)
    sgd = optimizer.SGD(optimizer.SGDParams(max_iter=4, global_batch_size=20))
    sgd.optimize(losses.HingeLoss(), np.zeros(wide), x, y, None, device="cpu")
    assert launched == [(wide, 0, 0, 20), (wide, 20, 0, 20), (wide, 30, 10, 20),
                        (wide, 0, 0, 20)]
    assert kernels.launch_counts["sgd_batch_terms"] == 4
    assert kernels.launch_counts["reduce_partials"] == 0
    kernels.reset_launch_counts()


class _FakeSgdLibrary:
    """Stands in for the built ``sgd_kernels`` library on the CPU: its one
    C entry reads the tensors behind the pointers it is given, computes the
    round's terms with the plain version and writes them where the kernel's
    second stage would, the row after the ``blocks`` partial rows."""

    def __init__(self, n):
        self.n, self.calls = n, []

    def sgd_batch_terms(self, x, y, w, coeffs, ws, start, lb, clip, d, v,
                        vec4, blocks, rows, dc, smem, segments, owner,
                        cluster, grid, scratch, scratch_floats, loss,
                        combine, stream):
        self.calls.append(dict(start=start, lb=lb, clip=clip, d=d, v=v,
                               blocks=blocks, cluster=cluster, grid=grid,
                               scratch=scratch, rows=rows, loss=loss,
                               combine=combine, owner=owner,
                               scratch_floats=scratch_floats))

        def tensor(ptr, count):
            arr = (ctypes.c_float * count).from_address(ptr)
            return torch.from_numpy(np.ctypeslib.as_array(arr).copy())

        name = {i: k for k, i in kernels.SGD_LOSSES.items()}[loss]
        out = kernels.sgd_batch_terms_plain(
            tensor(x, self.n * d).view(self.n, d), tensor(y, self.n),
            tensor(w, self.n), tensor(coeffs, d), start, clip, lb, name)
        ctypes.memmove(ws + 4 * blocks * (d + 2), out.numpy().ctypes.data,
                       4 * (d + 2))
        return 0


@pytest.mark.parametrize("d", [5, 600, 16_000, 120_000])
def test_one_c_call_per_round_on_the_card_path(monkeypatch, d):
    """On the card path every round is one call of the C entry, with both
    stages (combine = 1) and the plan's instance, and no reduce_partials
    launch; the grid instance's call gets its scratch, and its size, the
    rest none; no call but the two-pass set's names an owner width; the
    fit it gives is the plain fit (a stand-in library computes the terms
    with the plain version and writes them where the kernel would)."""
    x, y, w = _data(81, 70, d)
    fake = _FakeSgdLibrary(70)
    monkeypatch.setattr(kernels, "_is_cuda", lambda t: True)
    monkeypatch.setattr(kernels, "_lib", lambda source: fake)
    monkeypatch.setattr(kernels, "_on_card", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_device_index", lambda t: 0)
    monkeypatch.setattr(kernels, "_sgd_resident_blocks", lambda *a: 264)
    monkeypatch.setattr(kernels, "_sgd_resident_clusters", lambda *a: 264)
    monkeypatch.setattr(kernels, "_card_sms", lambda i: 132)
    monkeypatch.setattr(kernels, "_sgd_resident_grid", lambda *a: 132)
    kernels._sgd_plan_on.cache_clear()
    kernels.reset_launch_counts()
    prm = optimizer.SGDParams(max_iter=5, global_batch_size=30, reg=0.01)
    card = optimizer.sgd_rounds(kernels.sgd_batch_terms, "logistic", prm,
                                _t(x), _t(y), _t(w), torch.zeros(d))
    counts = dict(kernels.launch_counts)
    kernels.reset_launch_counts()
    assert counts["sgd_batch_terms"] == 5 and counts["reduce_partials"] == 0
    assert len(fake.calls) == 5
    kernels._sgd_plan_on.cache_clear()
    v = 0 if d > 512 else 1
    for call in fake.calls:
        assert call["combine"] == 1 and call["d"] == d and call["v"] == v
        assert call["loss"] == kernels.SGD_LOSSES["logistic"]
        plan = kernels._sgd_plan(call["lb"], d, 264, sms=132)
        assert call["blocks"] == plan.blocks and call["rows"] == plan.rows
        assert call["cluster"] == plan.cluster and call["grid"] == plan.grid
        assert (plan.cluster > 0) == (13_209 < d <= 105_568)
        assert (plan.grid > 0) == (d > 105_568) == (call["scratch"] is not None)
        assert call["scratch_floats"] == (
            2 * plan.rows * (plan.grid + 1) + 2 if plan.grid else 0)
        assert call["owner"] == plan.owner == 0
    monkeypatch.setattr(kernels, "_is_cuda", lambda t: False)
    plain = optimizer.sgd_rounds(kernels.sgd_batch_terms, "logistic", prm,
                                 _t(x), _t(y), _t(w), torch.zeros(d))
    for got, want in zip(card, plain):
        assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))


def test_lr_fit_at_262144_columns_matches_jax(mesh1):
    """A small LR fit at 262,144 dense columns (2^18, the grid instance's
    width on the card): 64 rows, every round all of them, 3 rounds,
    against the JAX fit, which takes its XLA rounds at this width (its
    Pallas kernel stops near 110,000 columns). The learning rate keeps the
    margins near 1 over so many columns. FIT_RTOL/FIT_ATOL (module
    docstring)."""
    d = 262_144
    x, y, w = _data(91, 64, d)
    prm = dict(learning_rate=1e-3, global_batch_size=64, max_iter=3,
               tol=0.0)
    want, want_loss, path = _jax_fit(mesh1, "logistic", prm, x, y, w)
    assert path == "xla-unrolled"
    got, got_loss = _port_fit("logistic", prm, x, y, w)
    assert 0.01 < got_loss < 0.7 and np.abs(want).max() > 1e-4
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_allclose(got_loss, want_loss, rtol=FIT_RTOL,
                               atol=FIT_ATOL)


def test_every_round_runs_the_kernel_wrapper(monkeypatch):
    calls = []
    real = kernels.sgd_batch_terms

    def counting(xl, yl, wl, coeffs, start, clip, lb, loss_name):
        calls.append((start, clip, lb, loss_name))
        return real(xl, yl, wl, coeffs, start, clip, lb, loss_name)

    monkeypatch.setattr(kernels, "sgd_batch_terms", counting)
    x, y, _ = _data(71, 50, 3)
    optimizer.SGD(optimizer.SGDParams(max_iter=4, global_batch_size=20)).optimize(
        losses.BinaryLogisticLoss(), np.zeros(3), x, y, None, device="cpu")
    assert calls == [(0, 0, 20, "logistic"), (20, 0, 20, "logistic"),
                     (30, 10, 20, "logistic"), (0, 0, 20, "logistic")]
