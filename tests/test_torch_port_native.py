"""The port's native runtime (``bigdl_tpu_torch.native``) against the
reference's (``bigdl_tpu.native``) and against its own plain versions.

Everything here is exact: CRCs are integers, the ring returns bytes, and
the image prep runs the same fp32 operations in the same order on both
sides (``(px - mean) * (1 / std)``), so the batches are compared bitwise.
"""
import ast
import os
from pathlib import Path

import numpy as np
import pytest

from bigdl_tpu import native as jnative
from bigdl_tpu.utils import crc32c as jcrc
from bigdl_tpu_torch import native
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.utils import crc32c as tcrc

REPO = Path(__file__).resolve().parents[1]


def _shards(tmp_path, n_files=3, n_records=10, rec=16, header=b""):
    paths, expect = [], []
    for fi in range(n_files):
        p = tmp_path / f"shard{fi}.bin"
        with open(p, "wb") as f:
            f.write(header)
            for r in range(n_records):
                payload = bytes([fi]) * (rec // 2) + bytes([r]) * (rec // 2)
                f.write(payload)
                expect.append(payload)
            f.write(b"x" * (rec // 3))       # a torn tail: not a record
        paths.append(str(p))
    return paths, expect


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 1000, 4099])
def test_crc32c_matches_the_reference(n):
    data = np.random.RandomState(n).bytes(n)
    assert tcrc.crc32c(data) == jcrc.crc32c(data)
    assert tcrc.masked_crc32c(data) == jcrc.masked_crc32c(data)
    assert tcrc.unmask(tcrc.masked_crc32c(data)) == jcrc.crc32c(data)
    half = n // 2
    assert tcrc.crc32c(data[half:], tcrc.crc32c(data[:half])) \
        == jcrc.crc32c(data)
    assert tcrc.mask(tcrc.crc32c(data)) == jcrc.masked_crc32c(data)


def test_crc32c_check_value():
    assert tcrc.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_ring_returns_every_record_as_the_reference(tmp_path, workers):
    paths, expect = _shards(tmp_path, header=b"HD")
    pf = native.NativePrefetcher(paths, 16, header_bytes=2, capacity=4,
                                 n_workers=workers)
    got = list(pf)
    pf.close()
    ref = jnative.NativePrefetcher(paths, 16, header_bytes=2, capacity=4,
                                   n_workers=workers)
    want = list(ref)
    ref.close()
    plain = list(native.read_records_plain(paths, 16, header_bytes=2))
    assert plain == expect
    assert sorted(got) == sorted(want) == sorted(expect)
    if workers == 1:                 # one worker: file order
        assert got == expect


def test_ring_loop_mode_and_close(tmp_path):
    paths, expect = _shards(tmp_path, n_files=1, n_records=4)
    pf = native.NativePrefetcher(paths, 16, capacity=2, n_workers=1,
                                 loop=True)
    got = [pf.next() for _ in range(10)]
    assert got == (expect * 3)[:10]
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf.next()
    with pytest.raises(FileNotFoundError):
        native.NativePrefetcher([str(tmp_path / "missing")], 16)


def _batch(seed, n=6, h=20, w=17, c=3, crop=(12, 9)):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n, h, w, c)).astype(np.uint8)
    offs = np.stack([rs.randint(0, h - crop[0] + 1, n),
                     rs.randint(0, w - crop[1] + 1, n)], 1)
    flips = rs.randint(0, 2, n)
    return images, offs, flips


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("given", ["offsets+flips", "none"])
def test_prepare_image_batch_bitwise(threads, given):
    images, offs, flips = _batch(threads)
    kw = dict(mean=(103.5, 116.25, 123.75), std=(57.3, 57.1, 0.0))
    if given == "none":
        offs = flips = None
    got = native.prepare_image_batch(images, 12, 9, offs, flips,
                                     n_threads=threads, **kw)
    plain = native.prepare_image_batch_plain(images, 12, 9, offs, flips,
                                             **kw)
    ref = jnative.prepare_image_batch(images, 12, 9, offs, flips,
                                      n_threads=threads, **kw)
    assert got.shape == (6, 3, 12, 9) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, plain)


def test_prepare_image_batch_refuses_bad_arguments():
    images, offs, flips = _batch(0)
    with pytest.raises(ValueError, match="does not fit"):
        native.prepare_image_batch(images, 21, 9)
    with pytest.raises(ValueError, match="out of range"):
        native.prepare_image_batch(images, 12, 9, offs + 100, flips)
    with pytest.raises(ValueError, match="entries"):
        native.prepare_image_batch(images, 12, 9, mean=(0.0, 1.0))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that is not there, or one that fails,
    raises; nothing drops to Python."""
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path / "native")
    monkeypatch.setattr(_build, "_gxx", lambda: str(tmp_path / "no" / "g++"))
    with pytest.raises(OSError):
        _build.build_native()
    failing = tmp_path / "failing-cxx"
    failing.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    failing.chmod(0o755)
    monkeypatch.setattr(_build, "_gxx", lambda: str(failing))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ for native/src "
                                           "failed \\(rc=3\\).*broken"):
        _build.build_native()
    assert not _build.native_target().exists()
    monkeypatch.undo()
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path / "native")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_native()
    # and a load through such a build raises too
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.crc32c(b"abc")


def test_the_build_compiles_only_the_ports_own_sources(tmp_path):
    """The library is built from ``bigdl_tpu_torch/native/src`` into
    ``build/native``; no path of the build names the reference's
    package, and no source of the port's native package reads one."""
    target = _build.native_target()
    assert target.parent == REPO / "build" / "native"
    assert _build.NATIVE_SRC == REPO / "bigdl_tpu_torch" / "native" / "src"
    srcs = [_build.NATIVE_SRC / f"{n}.cpp" for n in _build.NATIVE_SOURCES]
    assert all(p.is_file() for p in srcs)
    for p in [target, _build.NATIVE_DIR, *srcs]:
        assert "bigdl_tpu/" not in str(p) + "/"
    for src in ("native/__init__.py", "ops/_build.py"):
        tree = ast.parse((REPO / "bigdl_tpu_torch" / src).read_text())
        docs = {id(node.body[0].value) for node in ast.walk(tree)
                if isinstance(node, (ast.Module, ast.FunctionDef,
                                     ast.ClassDef)) and ast.get_docstring(node)}
        strings = [n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and id(n) not in docs]
        assert not any("bigdl_tpu/" in s or "bigdl_tpu." in s
                       for s in strings), src
    # the built library is the one the port loads
    lib = native.load()
    assert os.path.samefile(lib._name, target)


def test_the_target_hashes_the_sources(monkeypatch, tmp_path):
    before = _build.native_target()
    for n in _build.NATIVE_SOURCES:
        (tmp_path / f"{n}.cpp").write_bytes(
            (_build.NATIVE_SRC / f"{n}.cpp").read_bytes())
    monkeypatch.setattr(_build, "NATIVE_SRC", tmp_path)
    assert _build.native_target() == before
    (tmp_path / "prefetch.cpp").write_text("// edited\n")
    assert _build.native_target() != before
