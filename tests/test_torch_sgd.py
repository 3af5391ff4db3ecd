"""The port's SGD chain, held against the JAX package piece by piece.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in ``flink_ml_tpu_torch`` on the CPU (the plain PyTorch
version of the ``sgd_batch_terms`` kernel). The JAX fits run on a one-device
mesh: on the tests' 8-device mesh every shard would take its own share of
each minibatch, a different schedule from the port's single device.

Tolerances, all float32 against float32:
- batch terms against the Pallas kernel in interpret mode: rtol 2e-5,
  atol 1e-5, the bound of the JAX package's own kernel test (sums of 16
  rows added in another order);
- elementwise terms, regularization and the update rules: rtol 1e-6,
  atol 1e-7 (the same float32 operations, at most an ulp apart where the
  two frameworks round a Python scalar differently);
- whole fits: rtol 1e-5, atol 1e-7 on coefficients and the loss. Up to 70
  rounds of sums reassociated by another matrix-vector product differ by
  less than 1e-6 relative on these inputs; the bound leaves a factor of 10
  for other BLAS builds, and is ten times tighter than the 1e-4 that float32
  reassociation over a long fit could ask for.
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
    rows the chunked one, staged in chunks of columns that keep a column on
    one thread (a multiple of 256)."""
    for d in (1, 7, 100, 128, 129, 256, 300, 511, 512):
        plan = kernels._sgd_plan(100_000, d, 396)
        assert plan.instance == "registers" and plan.v == -(-d // 128)
        assert plan.blocks == 396 and plan.tiles_per_block == 0
    assert kernels._sgd_plan(1_000, 100, 396).blocks == 8  # 16 rows a warp
    assert kernels._sgd_layout(1_500) == (16, 512, 4 * (16 * 512 + 512 + 48))
    for d in (513, 1_500, 6_001, 10 ** 5, 10 ** 7):
        plan = kernels._sgd_plan(100_000, d, 792)
        rows, dc, smem = kernels._sgd_layout(d)
        assert plan.instance == "chunked" and plan.v == 0
        assert (plan.rows, plan.dc, plan.smem) == (rows, dc, smem)
        assert 16 <= rows <= 64 and rows & (rows - 1) == 0
        assert rows * dc <= kernels.SGD_TILE_FLOATS
        assert smem <= kernels.SMEM_BLOCK_BYTES
        assert dc % 256 == 0 and plan.blocks <= 792


@pytest.mark.parametrize("d", [7, 100, 512, 513, 6_001])
@pytest.mark.parametrize("lb", [1, 31, 100, 100_003])
def test_the_sgd_plan_covers_the_window_once(lb, d):
    """Stage 1's workers (warps of the register instance, blocks of the
    chunked one) take contiguous runs that cover [0, lb) once, in order;
    the register instance's runs differ by at most one row, and its grid
    gives every warp SGD_WARP_ROWS rows or fills the card."""
    resident = 396
    plan = kernels._sgd_plan(lb, d, resident)
    assert plan.instance == ("registers" if d <= 512 else "chunked")
    assert 1 <= plan.blocks <= resident
    runs = kernels.sgd_runs(plan, lb)
    assert runs[0][0] == 0 and runs[-1][1] == lb
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    lengths = [r1 - r0 for r0, r1 in runs]
    if plan.instance == "registers":
        assert len(runs) == plan.blocks * kernels.SGD_WARPS
        assert max(lengths) - min(lengths) <= 1
        assert (plan.blocks == resident or plan.blocks == -(-lb // (
            kernels.SGD_WARPS * kernels.SGD_WARP_ROWS)))
    else:
        span = plan.tiles_per_block * plan.rows
        assert len(runs) == plan.blocks and min(lengths) >= 1
        assert all(n == span for n in lengths[:-1])


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
                        vec4, blocks, rows, dc, smem, tiles_per_block, loss,
                        combine, stream):
        self.calls.append(dict(start=start, lb=lb, clip=clip, d=d, v=v,
                               blocks=blocks, loss=loss, combine=combine))

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


@pytest.mark.parametrize("d", [5, 600])
def test_one_c_call_per_round_on_the_card_path(monkeypatch, d):
    """On the card path every round is one call of the C entry, with both
    stages (combine = 1) and the plan's instance, and no reduce_partials
    launch; the fit it gives is the plain fit (a stand-in library computes
    the terms with the plain version and writes them where the kernel
    would)."""
    x, y, w = _data(81, 70, d)
    fake = _FakeSgdLibrary(70)
    monkeypatch.setattr(kernels, "_is_cuda", lambda t: True)
    monkeypatch.setattr(kernels, "_lib", lambda source: fake)
    monkeypatch.setattr(kernels, "_on_card", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_device_index", lambda t: 0)
    monkeypatch.setattr(kernels, "_sgd_resident_blocks", lambda *a: 264)
    kernels.reset_launch_counts()
    prm = optimizer.SGDParams(max_iter=5, global_batch_size=30, reg=0.01)
    card = optimizer.sgd_rounds(kernels.sgd_batch_terms, "logistic", prm,
                                _t(x), _t(y), _t(w), torch.zeros(d))
    counts = dict(kernels.launch_counts)
    kernels.reset_launch_counts()
    assert counts["sgd_batch_terms"] == 5 and counts["reduce_partials"] == 0
    assert len(fake.calls) == 5
    v = 0 if d > 512 else 1
    for call in fake.calls:
        assert call["combine"] == 1 and call["d"] == d and call["v"] == v
        assert call["loss"] == kernels.SGD_LOSSES["logistic"]
        assert call["blocks"] == kernels._sgd_plan(call["lb"], d, 264).blocks
    monkeypatch.setattr(kernels, "_is_cuda", lambda t: False)
    plain = optimizer.sgd_rounds(kernels.sgd_batch_terms, "logistic", prm,
                                 _t(x), _t(y), _t(w), torch.zeros(d))
    for got, want in zip(card, plain):
        assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))


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
