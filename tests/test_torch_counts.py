"""``repro_torch.roofline.counts``: what ``record_step`` counts — the
counterpart of tests/test_hlo_accounting.py.  The reference parses a
compiled module and must recover scanned bodies' trip counts; eager
PyTorch runs every layer, so a Python loop of G layers counts G times one
layer.  A DTensor op counts this rank's local work, the collectives their
bytes, and a kernel call on fake tensors its bound's FLOPs and bytes
without launching anything."""

import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels import ops, ref
from repro_torch.roofline import counts

M, K = 64, 32


@pytest.fixture
def fake_world_4():
    """A fake world of four ranks for one test, destroyed after it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized(), "a default process group exists"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_single_matmul_exact():
    a, b = torch.rand(M, K), torch.rand(K, M)
    with counts.record_step() as rec:
        a @ b
    w = counts.weighted_op_costs(rec)
    assert w["dot_flops"] == 2 * M * M * K
    assert w["dot_count"] == 1
    assert "aten::mm" in rec.as_text()
    # the operands read once and the result written once
    assert rec.bytes == (2 * M * K + M * M) * 4


@pytest.mark.parametrize("G", [3, 17])
def test_loop_counts_every_layer(G):
    x, ws = torch.rand(M, K), torch.rand(G, K, K)

    def run(n):
        with counts.record_step() as rec:
            y = x
            for g in range(n):
                y = torch.tanh(y @ ws[g])
        return rec

    one, many = run(1), run(G)
    assert many.dot_flops == G * 2 * M * K * K == G * one.dot_flops
    assert many.bytes == G * one.bytes
    assert many.ops["aten::mm"] == G


def test_bf16_matmul_counts_at_the_bf16_rate():
    a = torch.rand(M, K, dtype=torch.bfloat16)
    with counts.record_step() as rec:
        a @ a.T
    assert rec.flops_by_rate == {"bfloat16": 2.0 * M * M * K}


def test_dtensor_matmul_counts_the_local_work(fake_world_4):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = init_device_mesh("cpu", (4,))
    A = distribute_tensor(torch.rand(M, K), mesh, [Shard(0)])
    B = distribute_tensor(torch.rand(K, M), mesh, [Replicate()])
    with counts.record_step() as rec:
        A @ B
    # the global product would be 2·M·M·K; this rank computes a quarter
    assert rec.dot_flops == 2 * M * M * K / 4


def test_collectives_counted_with_their_bytes(fake_world_4):
    x = torch.rand(M, K)
    out = torch.empty(4 * M, K)
    with counts.record_step() as rec:
        dist.all_reduce(x)
        dist.all_gather_into_tensor(out, x)
    st = counts.collective_stats(rec)
    nbytes = M * K * 4
    assert dict(st.counts) == {"all-reduce": 1, "all-gather": 1}
    assert st.wire_bytes["all-reduce"] == 2 * 3 / 4 * nbytes
    assert st.wire_bytes["all-gather"] == 3 / 4 * (4 * nbytes)
    assert st.bytes_moved["all-gather"] == 4 * nbytes
    assert counts.collective_dtype_stats(rec) == [
        ("all-reduce", "f32", (M, K)), ("all-gather", "f32", (M, K))]
    assert rec.collective_ranks == [(0, 1, 2, 3)] * 2


def test_collectives_recorded_and_never_sent(fake_world_4, monkeypatch):
    """A counted step issues no collective: the one it calls is logged and
    answered with its output as it was."""
    def sent(*args, **kw):
        raise AssertionError("record_step issued a collective")

    monkeypatch.setattr(dist, "all_reduce", sent)
    x = torch.ones(3)
    with counts.record_step() as rec:
        dist.all_reduce(x)
    assert len(rec.collectives) == 1
    assert torch.equal(x, torch.ones(3))


@pytest.mark.parametrize("device", ["meta", "fake cuda"])
def test_fake_kernel_call_records_its_bound(device):
    """A kernel wrapper on data-less tensors records its plan's FLOPs and
    bytes and returns an empty output of the right shape; nothing is
    launched or counted in LAUNCHES."""
    ops.reset_launches()
    m, n, k = 1000, 300, 50
    ctx = counts.fake_mode() if device == "fake cuda" else torch.device(
        "meta")
    with ctx:
        dev = "cuda" if device == "fake cuda" else "meta"
        A = torch.empty(m, n, device=dev)
        B = torch.empty(n, k, device=dev)
        W = torch.empty(m, k, device=dev)
        G = torch.empty(k, k, device=dev)
        with counts.record_step() as rec:
            C = ops.ts_matmul(A, B)
            Y = ops.ts_matmul_t(A, W)
            Gw = ops.gram(W)
            X = ops.mu_update(W, G, W)
            Xh = ops.hals_sweep(W, G, W)
    assert (tuple(C.shape), tuple(Y.shape), tuple(Gw.shape),
            tuple(X.shape), tuple(Xh.shape)) == ((m, k), (n, k), (k, k),
                                                  (m, k), (m, k))
    assert C.dtype == torch.float32 and C.device.type == dev
    assert all(v == 0 for v in ops.LAUNCHES.values())
    calls = {c.name: c for c in rec.kernels}
    assert set(calls) == {"ts_matmul", "ts_matmul_t", "gram", "mu_update",
                          "hals_sweep"}
    assert calls["ts_matmul"].flops == 2.0 * m * n * k
    assert calls["ts_matmul"].bytes == (m * n + n * k + m * k) * 4
    assert calls["ts_matmul"].rate == "tf32x3"
    assert calls["ts_matmul_t"].bytes == (m * n + m * k + n * k) * 4
    assert calls["gram"].flops == 1.0 * m * k * (k + 1)
    assert calls["gram"].bytes == (m * k + k * k) * 4
    assert calls["mu_update"].flops == 2.0 * m * k * k
    assert calls["mu_update"].bytes == 3 * m * k * 4 + k * k * 4
    assert calls["mu_update"].rate == "float32"
    assert rec.kernel_calls()["ts_matmul"] == 1
    assert "kernel ts_matmul" in rec.as_text()


def test_fake_sparse_kernel_calls_record():
    nnz, m, n, k = 5000, 800, 600, 16
    with torch.device("meta"):
        vals = torch.empty(nnz)
        idx = torch.empty(nnz, dtype=torch.int32)
        B = torch.empty(n, k)
        with counts.record_step() as rec:
            out = ops.spmm(vals, idx, idx, B, m)
            out_t = ops.spmm_t(vals, idx, idx, torch.empty(m, k), n)
    assert tuple(out.shape) == (m, k) and tuple(out_t.shape) == (n, k)
    assert [c.name for c in rec.kernels] == ["spmm", "spmm"]
    assert rec.kernels[0].flops == 2.0 * nnz * k
    assert rec.kernels[0].bytes == nnz * 12 + n * k * 4 + m * k * 4


def test_real_cpu_tensors_take_the_plain_path():
    """A real tensor behaves as before: a CPU tensor runs the plain version
    and records no kernel call; what raised still raises."""
    ops.reset_launches()
    A, B = torch.rand(40, 30), torch.rand(30, 5)
    with counts.record_step() as rec:
        got = ops.ts_matmul(A, B)
    torch.testing.assert_close(got, ref.ts_matmul(A, B), rtol=0, atol=0)
    assert rec.kernels == [] and rec.dot_flops == 2 * 40 * 30 * 5
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError, match="contiguous"):
        ops.ts_matmul(A.T, torch.rand(40, 5))


def test_peak_counts_live_storages():
    x = torch.rand(M, K)
    with counts.record_step() as rec:
        y = x * 2                 # one new (M, K) storage
        z = y[:, :4]              # a view: nothing new
        del y, z
        w = x + 1                 # the first was freed: still one at a time
        w.add_(1)                 # in place: nothing new
    assert rec.peak_bytes == M * K * 4
