"""The port's native tokenizer (``pyslam_tpu_torch.native``) and the readers
on it, against the JAX package's ``native`` and readers: the twin of
``tests/test_native_io.py``.

Everything is compared to the bit: the kernels' values, structures and
error messages (byte offsets included) against the reference's native
functions; every file kind that ``tests/test_native_io.py`` covers (SE(2),
SE(3), Sim(3), landmark g2o files, BAL) through the port's native path,
its plain tokenizers (``g2o._tokenize_g2o_plain``, ``bal._parse_bal_plain``)
and the JAX package's reader.  The reference's ``TestFallbackReaders`` runs
the readers with their native library switched off; the port has no such
fallback, so its twin round-trips files through the plain tokenizers.  A
failed build raises (the reference returns False from ``available()``).
"""

import numpy as np
import pytest

from pyslam_tpu import native as jnative
from pyslam_tpu.io import bal as jbal
from pyslam_tpu.io import g2o as jg2o
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu_torch import native
from pyslam_tpu_torch.io import bal, g2o
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

VALUES = b" 1.5\t2e3\n-4.25 +6 7.0e-2 8 \n\n.5 -.5 1e-300 12345678901234.5"
TAGGED = (b"# comment line\n"
          b"TAG_A 1 2.5 -3\n"
          b"UNKNOWN stuff that is not numeric\n"
          b"TAG_B 4\n"
          b"   TAG_A 5 6 7\n"
          b"TAG_A 8 9 10")  # no trailing newline


def _error(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_parse_doubles_values():
    got = native.parse_doubles(VALUES)
    np.testing.assert_array_equal(got, np.array(VALUES.split(), dtype=np.float64))
    np.testing.assert_array_equal(got, jnative.parse_doubles(VALUES))
    assert native.count_tokens(VALUES) == jnative.count_tokens(VALUES) == (10, 4)


@pytest.mark.parametrize("buf", [b"1 2 x 3", b"7 8 9 --1"])
def test_parse_doubles_empty_and_bad(buf):
    assert len(native.parse_doubles(b"")) == 0
    assert len(native.parse_doubles(b"  \n \t ")) == 0
    msg = _error(native.parse_doubles, buf)
    assert msg == _error(jnative.parse_doubles, buf)
    assert "bad token at byte" in msg


# (buffer, byte of the malformed token)
SPLIT_TOKENS = [(b"1.5\n2 3e\n", 6), (b"7 8 1-2", 4), (b"1.5.5 2", 0), (b"4 +-5", 2)]


@pytest.mark.parametrize("buf,at", SPLIT_TOKENS)
def test_a_token_is_one_number(buf, at):
    """A token that does not end where its number ends is malformed, as the
    plain tokenizer (``float()``) holds it.  The reference's scanner reads
    "1-2" as two numbers, 1 and -2 (``parse_doubles`` then raises "output
    overflow", ``scan_tagged`` returns both); the port raises at the token."""
    assert _error(native.parse_doubles, buf) == f"parse_doubles: bad token at byte {at}"
    with pytest.raises(ValueError):
        bal._parse_bal_plain(buf)
    tagged = b"TAG_A " + buf.replace(b"\n", b" ") + b"\n"
    assert _error(native.scan_tagged, tagged, ["TAG_A"]) == f"scan_tagged: bad token at byte {at + 6}"


def test_a_g2o_record_with_a_split_token_raises(tmp_path):
    """The reference reads "VERTEX_SE2 0 1-2 0" as the pose (1, -2, 0); the
    port refuses the file, as its plain tokenizer does."""
    p = tmp_path / "split.g2o"
    p.write_text("VERTEX_SE2 0 1-2 0\n")
    np.testing.assert_array_equal(jg2o._tokenize_g2o(p)["VERTEX_SE2"], [[0, 1, -2, 0]])
    assert _error(g2o.read_g2o, p) == "scan_tagged: bad token at byte 13"
    with pytest.raises(ValueError, match="could not convert"):
        g2o._tokenize_g2o_plain(p)


def test_scan_tagged_structure():
    got = native.scan_tagged(TAGGED, ["TAG_A", "TAG_B"])
    ref = jnative.scan_tagged(TAGGED, ["TAG_A", "TAG_B"])
    ids, offs, cnts, fields = got
    assert ids.tolist() == [0, 1, 0, 0]
    assert cnts.tolist() == [3, 1, 3, 3]
    rows = [fields[o:o + c].tolist() for o, c in zip(offs, cnts)]
    assert rows == [[1, 2.5, -3], [4], [5, 6, 7], [8, 9, 10]]
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    n = int(offs[-1] + cnts[-1])
    np.testing.assert_array_equal(fields[:n], ref[3][:n])


def test_scan_tagged_bad_numeric():
    buf = b"TAG_A 1 oops\n"
    msg = _error(native.scan_tagged, buf, ["TAG_A"])
    assert msg == _error(jnative.scan_tagged, buf, ["TAG_A"]) == "scan_tagged: bad token at byte 8"


def _same_arrays(a, b):
    """Every array field of two reader results, to the bit."""
    assert type(a).__name__ == type(b).__name__
    names = [k for k, v in vars(b).items() if isinstance(v, np.ndarray)]
    assert names
    for k in names:
        x, y = getattr(a, k), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    for k, v in vars(b).items():
        if not isinstance(v, np.ndarray):
            assert getattr(a, k) == v, k


G2O_FILES = {
    "se2": lambda p: jg2o.write_g2o(p, jsynth.se2_loop(40, seed=3)),
    "se3": lambda p: jg2o.write_g2o(p, jsynth.se3_sphere(60, seed=4)),
    "sim3": lambda p: jg2o.write_g2o(p, jsynth.sim3_loop(30, seed=5)),
    "landmarks": lambda p: jg2o.write_g2o_landmarks(
        p, jsynth.landmark_slam_2d(30, n_landmarks=12, obs_type="xy", seed=6)),
}


@pytest.mark.parametrize("name", sorted(G2O_FILES))
def test_g2o_native_equals_plain_and_reference(name, tmp_path):
    p = tmp_path / "a.g2o"
    G2O_FILES[name](p)
    fast = g2o.read_g2o(p)
    recs, plain_recs = g2o._tokenize_g2o(p), g2o._tokenize_g2o_plain(p)
    assert sorted(recs) == sorted(plain_recs)
    for k in recs:
        np.testing.assert_array_equal(recs[k], plain_recs[k])
    _same_arrays(fast, g2o.read_g2o(p, _recs=plain_recs))
    _same_arrays(fast, jg2o.read_g2o(p))
    if name == "sim3":
        assert fast.sqrt_info.shape[-1] == 7


def test_bal_native_equals_plain_and_reference(tmp_path):
    p = str(tmp_path / "a.bal")
    jbal.write_bal(p, jbal.synthetic_bal(6, 50, obs_per_pt=3, seed=7))
    fast = bal.read_bal(p)
    _same_arrays(fast, bal.read_bal(p, _parse=bal._parse_bal_plain))
    _same_arrays(fast, jbal.read_bal(p))


def test_switchable_file_reads_through_the_native_scanner(tmp_path, monkeypatch):
    """``read_g2o_switchable`` tokenizes through ``_tokenize_g2o``, once."""
    data = jsynth.se2_loop(n_poses=30, n_loops=4, seed=0)
    loop = np.abs(np.asarray(data.edges_i) - np.asarray(data.edges_j)) != 1
    p = tmp_path / "sw.g2o"
    jg2o.write_g2o_switchable(p, data, loop, xi=3.0)
    calls = []
    scan = native.scan_tagged
    monkeypatch.setattr(native, "scan_tagged", lambda *a: calls.append(1) or scan(*a))
    data, sw = g2o.read_g2o_switchable(p)
    jdata, jsw = jg2o.read_g2o_switchable(p)
    assert calls == [1]
    _same_arrays(data, jdata)
    assert sorted(sw) == sorted(jsw)
    for k in sw:
        np.testing.assert_array_equal(sw[k], jsw[k])


def test_plain_g2o_round_trip(tmp_path):
    """The reference's fallback round trip, on the port's plain tokenizer."""
    data = jsynth.se2_loop(25, seed=8)
    p = tmp_path / "a.g2o"
    g2o.write_g2o(p, data)
    back = g2o.read_g2o(p, _recs=g2o._tokenize_g2o_plain(p))
    np.testing.assert_allclose(back.T_init, data.T_init, atol=1e-7)


def test_plain_bal_round_trip(tmp_path):
    data = jbal.synthetic_bal(4, 30, obs_per_pt=3, seed=9)
    p = str(tmp_path / "a.bal")
    bal.write_bal(p, data)
    back = bal.read_bal(p, _parse=bal._parse_bal_plain)
    np.testing.assert_allclose(back.T, data.T, atol=1e-12)


MALFORMED = {
    "missing vertex id 1": "VERTEX_SE2 0 0 0 0\nVERTEX_SE2 2 1 0 0\n",
    "expected 4": "VERTEX_SE2 0 0 0\n",
    "unknown pose id 5": "VERTEX_SE2 0 0 0 0\nVERTEX_XY 1 1 1\nEDGE_SE2_XY 5 1 0.5 0.5 1 0 1\n",
}


@pytest.mark.parametrize("match", sorted(MALFORMED))
def test_malformed_files_raise_as_the_reference(match, tmp_path):
    p = tmp_path / "bad.g2o"
    p.write_text(MALFORMED[match])
    msg = _error(g2o.read_g2o, p)
    assert match in msg
    assert msg == _error(jg2o.read_g2o, p)
    if match == "expected 4":
        assert msg == _error(g2o._tokenize_g2o_plain, p)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that is not there, and one that fails: both raise with
    what went wrong, and nothing is loaded in place of the library."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+ not found"):
        native.available()
    with pytest.raises(RuntimeError, match="not found"):
        native.parse_doubles(b"1 2")
    failing = tmp_path / "failing-g++"
    failing.write_text("#!/bin/sh\necho 'fastio.cpp:1: error: broken' >&2\nexit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(failing))
    with pytest.raises(RuntimeError, match="(?s)failed \\(1\\).*error: broken"):
        native.available()
    assert native._lib is None
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    """A fresh build goes to its own directory under the build root, named
    by the hash, through a temporary file renamed into place; a second call
    finds it."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path / "build")
    path = native.build()
    assert path.parent.parent == tmp_path / "build" and path.name == "libfastio.so"
    assert [p.name for p in path.parent.iterdir()] == ["libfastio.so"]
    assert native.build() == path
    np.testing.assert_array_equal(native.parse_doubles(VALUES), jnative.parse_doubles(VALUES))
