"""Port parity, record IO and snapshots on the CPU: files written by each
package, through each backend, are read by the other package's every
backend, and corruption is detected.

- `io.RecordWriter`/`RecordReader`: the native library (g++-built
  `native/recordio.cc`) and the pure-Python backend, against the JAX
  package's native and pure-Python ones: the same records, in order; a
  flipped value byte, a flipped length byte, a truncated file and a bad
  magic raise OSError;
  the backend is chosen by name only, and a native source that does not
  compile raises with the compiler's output;
- `snapshot.Snapshot`: the native `.bin` and the `.npz` backends against
  the JAX package's, both directions, reads taking what is on disk;
  fp32, int32, bool, 0-d and (native) bfloat16 values; a flipped byte, a
  file cut at a record boundary (caught by the `.meta` manifest) and a
  missing snapshot raise."""

import os

import numpy as np
import pytest
import torch

from singa_tpu import io as jio
from singa_tpu import native as jnative
from singa_tpu import snapshot as jsnapshot
from singa_tpu import tensor as jt
from singa_tpu_torch import io as tio
from singa_tpu_torch import native as tnative
from singa_tpu_torch import snapshot as tsnapshot

RECORDS = [(f"key{i}", bytes(np.random.RandomState(i).randint(
    0, 256, 37 * i + 1).astype(np.uint8))) for i in range(6)] \
    + [("", b""), ("utf8-ключ", b"\x00\xff" * 1000)]
BACKENDS = ["port-native", "port-python", "jax-native", "jax-python"]


def _jax_python(monkeypatch):
    monkeypatch.setattr(jnative, "lib", lambda: None)
    monkeypatch.setattr(jnative, "snapshot_lib", lambda: None)


def _write(path, who, monkeypatch):
    pkg, backend = who.split("-")
    if pkg == "port":
        with tio.RecordWriter(path, backend=backend) as w:
            for k, v in RECORDS:
                w.write(k, v)
        return
    with monkeypatch.context() as mp:
        if backend == "python":
            _jax_python(mp)
        with jio.RecordWriter(path) as w:
            for k, v in RECORDS:
                w.write(k, v)


def _read(path, who, monkeypatch):
    pkg, backend = who.split("-")
    if pkg == "port":
        with tio.RecordReader(path, backend=backend) as r:
            return list(r)
    with monkeypatch.context() as mp:
        if backend == "python":
            _jax_python(mp)
        r = jio.RecordReader(path)
        try:
            return list(r)
        finally:
            r.close()


@pytest.mark.parametrize("reader", BACKENDS)
@pytest.mark.parametrize("writer", BACKENDS)
def test_records_cross_packages(tmp_path, monkeypatch, writer, reader):
    path = str(tmp_path / "r.rio")
    _write(path, writer, monkeypatch)
    got = _read(path, reader, monkeypatch)
    assert got == [(k.encode(), v) for k, v in RECORDS]


@pytest.mark.parametrize("backend", ["native", "python"])
def test_records_corruption_detected(tmp_path, backend):
    path = str(tmp_path / "r.rio")
    with tio.RecordWriter(path, backend="native") as w:
        for k, v in RECORDS:
            w.write(k, v)
    raw = bytes(open(path, "rb").read())
    second = 8 + (4 + 4 + 8 + 1 + 4)          # the second record's start

    def flip(at):
        return raw[:at] + bytes([raw[at] ^ 0xFF]) + raw[at + 1:]

    cases = {"value": flip(second + 4 + 4 + 8 + 5),
             "length": flip(second + 4 + 4 + 7),
             "cut": raw[:len(raw) - 3],
             "magic": b"NOTMAGIC" + raw[8:]}
    for name, blob in cases.items():
        bad = str(tmp_path / f"{name}.rio")
        with open(bad, "wb") as f:
            f.write(blob)
        with pytest.raises(OSError):
            with tio.RecordReader(bad, backend=backend) as r:
                list(r)


def test_record_backend_by_name_and_failed_build(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="backend"):
        tio.RecordWriter(str(tmp_path / "x"), backend="fast")
    with pytest.raises(ValueError, match="backend"):
        tio.RecordReader(str(tmp_path / "x"), backend="auto")
    src = tmp_path / "src"
    src.mkdir()
    (src / "recordio.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(tnative, "_DIR", str(src))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on "
                       "native/recordio.cc") as e:
        tio.RecordWriter(str(tmp_path / "y"))
    assert "error" in str(e.value)


def _values():
    rng = np.random.RandomState(9)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "ids": rng.randint(-5, 5, (7,)).astype(np.int32),
            "mask": rng.rand(2, 2) > 0.5,
            "scalar": np.asarray(np.float32(2.5)),
            "layer.1.b": np.zeros((0,), np.float32)}


SNAP = ["port-native", "port-npz", "jax-native", "jax-npz"]


@pytest.mark.parametrize("reader", ["port", "jax"])
@pytest.mark.parametrize("writer", SNAP)
def test_snapshots_cross_packages(tmp_path, monkeypatch, writer, reader):
    vals = _values()
    pkg, backend = writer.split("-")
    path = str(tmp_path / ("snap.npz" if backend == "npz" else "snap"))
    mod = tsnapshot if pkg == "port" else jsnapshot
    with mod.Snapshot(path, True) as sn:
        for k, v in vals.items():
            sn.write(k, torch.from_numpy(v) if pkg == "port" else v)
    on_disk = sorted(os.listdir(tmp_path))
    assert on_disk == sorted(["snap.meta", "snap.npz" if backend == "npz"
                              else "snap.bin"])
    read_path = str(tmp_path / "snap")
    if reader == "port":
        back = tsnapshot.Snapshot(read_path, False)
        got = {k: back.read(k).data.numpy() for k in back.names()}
    else:
        back = jsnapshot.Snapshot(read_path, False)
        got = {k: np.asarray(jt.to_numpy(back.read(k)))
               for k in back.names()}
    assert sorted(got) == sorted(vals)
    for k, v in vals.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_bfloat16_native_both_ways(tmp_path, writer):
    import ml_dtypes
    vals = np.random.RandomState(3).randn(5, 3).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    path = str(tmp_path / "bf")
    if writer == "port":
        with tsnapshot.Snapshot(path, True) as sn:
            sn.write("x", t)
    else:
        with jsnapshot.Snapshot(path, True) as sn:
            sn.write("x", vals.astype(ml_dtypes.bfloat16))
    got = tsnapshot.Snapshot(path, False).read("x").data
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    jgot = np.asarray(jt.to_numpy(jsnapshot.Snapshot(path, False).read("x")))
    assert jgot.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(jgot.astype(np.float32),
                                  t.float().numpy())


def test_snapshot_corruption_detected(tmp_path):
    path = str(tmp_path / "s")
    with tsnapshot.Snapshot(path, True) as sn:
        for k, v in _values().items():
            sn.write(k, v)
    raw = open(path + ".bin", "rb").read()
    # the first record, "w": klen, key, dtype length, "float32", ndim,
    # two dims, nbytes, 48 value bytes, crc
    value = 8 + 4 + 1 + 1 + len("float32") + 1 + 2 * 8 + 8
    first = value + 48 + 4
    with open(path + ".bin", "wb") as f:          # a value byte flipped
        f.write(raw[:value + 5] + bytes([raw[value + 5] ^ 0xFF])
                + raw[value + 6:])
    with pytest.raises(OSError, match="corrupt"):
        tsnapshot.Snapshot(path, False)
    # cut at the end of the first record: clean framing, the .meta
    # manifest names what is missing
    with open(path + ".bin", "wb") as f:
        f.write(raw[:first])
    with pytest.raises(OSError, match="truncated"):
        tsnapshot.Snapshot(path, False)
    with pytest.raises(FileNotFoundError):
        tsnapshot.Snapshot(str(tmp_path / "none"), False)
