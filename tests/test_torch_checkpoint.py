"""The port's train checkpoints (``repro_torch.checkpoint.checkpoint``)
against the JAX package's: a step directory written by either package
restores in the other, key for key and bit for bit, for nested dict,
tuple, list and NamedTuple states; ``recover_payload`` repairs the
crash-between-renames window; ``keep_last`` prunes; ``AsyncCheckpointer``
snapshots the state before its thread starts.
"""

import collections
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jc
from repro_torch.checkpoint import checkpoint as tc
from repro_torch.checkpoint.checkpoint import CheckpointCorrupt

Carry = collections.namedtuple("Carry", "W Ht step")
Inner = collections.namedtuple("Inner", "norms counts")


def _state(seed=0):
    """A nested state of numpy arrays: dict → tuple → NamedTuple → list."""
    rng = np.random.default_rng(seed)
    return {
        "factors": Carry(W=rng.random((12, 4)).astype(np.float32),
                         Ht=rng.random((9, 4)).astype(np.float32),
                         step=np.asarray(7, np.int32)),
        "rule": (np.asarray([3, 1], np.int32),
                 Inner(norms=rng.random(4).astype(np.float32),
                       counts=[np.arange(3, dtype=np.int32),
                               np.asarray(2.5, np.float32)])),
        "aux": {"b": rng.random((2, 2)).astype(np.float32),
                "a": np.asarray([1.0, -0.0, np.inf], np.float32)},
    }


def _leaves(tree):
    return tc._flatten(tree)


def _as_torch(tree):
    return tc._map_leaves(tree, lambda _p, x: torch.as_tensor(np.asarray(x)))


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for key in la:
        x, y = np.asarray(la[key]), np.asarray(lb[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8))


def test_key_paths_equal_the_reference(tmp_path):
    st = _state()
    jc.save(_as_jax(st), 1, str(tmp_path / "jax"))
    tc.save(_as_torch(st), 1, str(tmp_path / "port"))
    files = []
    for who in ("jax", "port"):
        with np.load(tmp_path / who / "step_00000001" / "arrays.npz") as z:
            files.append(sorted(z.files))
    assert files[0] == files[1]
    assert "factors::.W" in files[0] and "rule::1::.counts::0" in files[0]


def test_jax_written_step_restores_in_the_port(tmp_path):
    st = _state(1)
    d = str(tmp_path / "ck")
    jc.save(_as_jax(st), 3, d)
    back, step = tc.restore(d, _as_torch(_state(2)))
    assert step == 3
    assert isinstance(back["factors"], Carry)
    assert isinstance(back["rule"], tuple)
    assert isinstance(back["rule"][1], Inner)
    assert isinstance(back["rule"][1].counts, list)
    kinds = []
    tc._map_leaves(back, lambda _p, x: kinds.append(type(x)))
    assert kinds and all(kind is torch.Tensor for kind in kinds)
    _assert_same_bits(tc._map_leaves(back, lambda _p, x: x.numpy()), st)


def test_port_written_step_restores_in_jax(tmp_path):
    st = _state(3)
    d = str(tmp_path / "ck")
    tc.save(_as_torch(st), 5, d, extra_meta={"note": "port"})
    back, step = jc.restore(d, _as_jax(_state(4)))
    assert step == 5
    _assert_same_bits(jax.tree.map(np.asarray, back), st)
    # and the port's payload verifies under the reference's reader
    arrays, meta = jc.read_payload(os.path.join(d, "step_00000005"))
    assert meta["note"] == "port" and meta["step"] == 5
    assert sorted(meta["keys"]) == sorted(arrays)


def test_restore_places_and_casts_by_the_template(tmp_path):
    st = _state(5)
    d = str(tmp_path / "ck")
    tc.save(_as_torch(st), 0, d)
    tmpl = _as_torch(st)
    tmpl["aux"]["b"] = tmpl["aux"]["b"].to(torch.float64)
    back, _ = tc.restore(d, tmpl, device="cpu")
    assert back["aux"]["b"].dtype == torch.float64
    np.testing.assert_array_equal(back["aux"]["b"].numpy(), st["aux"]["b"])
    bad = _as_torch(st)
    bad["factors"] = bad["factors"]._replace(W=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="shape"):
        tc.restore(d, bad)
    missing = _as_torch(st)
    missing["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="extra"):
        tc.restore(d, missing)
    assert tc.restore(str(tmp_path / "none"), tmpl) == (None, None)


def test_bf16_tensors_round_trip_through_float32(tmp_path):
    x = torch.randn(5, 3).to(torch.bfloat16)
    d = str(tmp_path / "ck")
    tc.save({"x": x}, 0, d)
    with np.load(os.path.join(d, "step_00000000", "arrays.npz")) as z:
        assert z["x"].dtype == np.float32
    back, _ = tc.restore(d, {"x": torch.zeros(5, 3, dtype=torch.bfloat16)})
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)


def test_keep_last_prunes_and_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert tc.latest_step(d) is None
    for step in (1, 2, 10, 11, 12):
        tc.save({"x": torch.full((2,), float(step))}, step, d, keep_last=3)
    assert sorted(os.listdir(d)) == ["step_00000010", "step_00000011",
                                     "step_00000012"]
    assert tc.latest_step(d) == 12 == jc.latest_step(d)
    back, step = tc.restore(d, {"x": torch.zeros(2)}, step=10)
    assert step == 10 and back["x"].tolist() == [10.0, 10.0]


def test_recover_payload_repairs_the_crash_between_renames(tmp_path):
    final = str(tmp_path / "step_00000004")
    tc.write_payload(final, {"x": np.arange(3)}, {"step": 4})
    assert tc.recover_payload(final) is False          # nothing to repair
    # a crash between ``os.replace(final, old)`` and the publish: final is
    # gone, the previous version sits aside, a half-written tmp is left
    old = str(tmp_path / ".old_step_00000004_123")
    os.replace(final, old)
    tmp = tmp_path / ".tmp_step_00000004_456"
    tmp.mkdir()
    (tmp / "arrays.npz").write_bytes(b"torn")
    assert tc.recover_payload(final) is True
    arrays, _ = tc.read_payload(final)
    np.testing.assert_array_equal(arrays["x"], np.arange(3))
    assert not tmp.exists() and not os.path.exists(old)
    # two aside copies: the newest is promoted, the older dropped
    os.replace(final, str(tmp_path / ".old_step_00000004_1"))
    tc.write_payload(str(tmp_path / "newer"), {"x": np.arange(5)}, {})
    newest = str(tmp_path / ".old_step_00000004_2")
    os.replace(str(tmp_path / "newer"), newest)
    os.utime(newest, (1e10, 1e10))
    assert tc.recover_payload(final) is True
    assert tc.read_payload(final)[0]["x"].shape == (5,)
    assert not any(p.name.startswith(".old_") for p in tmp_path.iterdir())
    assert tc.recover_payload(str(tmp_path / "absent")) is False


def test_recover_payload_matches_the_reference(tmp_path):
    """Both packages' recover_payload take the same directory state to the
    same result."""
    for who, recover in (("port", tc.recover_payload),
                         ("jax", jc.recover_payload)):
        final = str(tmp_path / who / "art")
        tc.write_payload(final, {"x": np.arange(4)}, {"v": 1})
        os.replace(final, str(tmp_path / who / ".old_art_9"))
        assert recover(final) is True
        assert tc.read_payload(final)[1]["v"] == 1


def test_async_checkpointer_snapshots_before_the_thread(tmp_path):
    """The caller mutates its tensor the moment save() returns, and again
    while the writer runs: the checkpoint holds the values at save()."""
    d = str(tmp_path / "ck")
    ck = tc.AsyncCheckpointer(d, keep_last=2)
    W = torch.zeros(256, 64)
    gate = threading.Event()
    real_save = tc.save

    def slow_save(*a, **kw):
        assert gate.wait(timeout=30)
        return real_save(*a, **kw)

    tc.save = slow_save
    try:
        ck.save({"W": W, "step": torch.tensor(1)}, 1)
        W.add_(5.0)                      # mutated while the write waits
        gate.set()
        ck.wait()
    finally:
        tc.save = real_save
    back, step = tc.restore(d, {"W": torch.empty(256, 64),
                                "step": torch.tensor(0)})
    assert step == 1 and float(back["W"].abs().max()) == 0.0
    assert ck.last_path.endswith("step_00000001")
    for step in (2, 3, 4):
        W.fill_(float(step))
        ck.save({"W": W, "step": torch.tensor(step)}, step)
        W.fill_(-1.0)
    ck.wait()
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    back, _ = tc.restore(d, {"W": torch.empty(256, 64),
                             "step": torch.tensor(0)})
    assert float(back["W"].min()) == float(back["W"].max()) == 4.0


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = tc.AsyncCheckpointer(str(blocker / "ck"))
    ck.save({"x": torch.zeros(2)}, 0)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                            # the error is reported once


def test_corrupt_step_is_detected(tmp_path):
    d = str(tmp_path / "ck")
    path = tc.save({"x": torch.arange(6.0)}, 2, d)
    npz = os.path.join(path, "arrays.npz")
    raw = bytearray(open(npz, "rb").read())
    raw[-30] ^= 0xFF
    open(npz, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorrupt):
        tc.read_payload(path)
