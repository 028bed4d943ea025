"""The port's open-loop arrival traces held against the reference's: the
same seed, shape, rate and duration give bitwise the same timestamps."""
import json

import numpy as np
import pytest

from bigdl_tpu.serving import arrivals as J
from bigdl_tpu_torch.serving import arrivals as T

SHAPES = [("steady", None), ("burst", None), ("overload", None),
          ("steady", "diurnal"), ("burst", "diurnal")]


def _gen(mod, seed, shape, diurnal, rate=4.0, duration=10.0):
    fn = mod.diurnal_mult if diurnal else None
    return list(mod.virtual_arrivals(np.random.RandomState(seed), rate,
                                     mod.TRACES[shape], duration,
                                     rate_fn=fn))


@pytest.mark.parametrize("shape,diurnal", SHAPES)
@pytest.mark.parametrize("seed", [0, 12])
def test_virtual_arrivals_bitwise(seed, shape, diurnal):
    want = _gen(J, seed, shape, diurnal)
    got = _gen(T, seed, shape, diurnal)
    assert len(got) == len(want) > 10
    assert got == want                  # float for float, no tolerance
    assert all(b > a for a, b in zip(got, got[1:]))
    assert got[-1] < 10.0


def test_one_draw_per_arrival_leaves_the_rng_where_the_reference_does():
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    n = len(list(T.virtual_arrivals(a, 8.0, T.TRACES["steady"], 5.0)))
    m = len(list(J.virtual_arrivals(b, 8.0, J.TRACES["steady"], 5.0)))
    assert n == m
    # interleaved size draws see the same stream on both sides
    assert a.randint(0, 1 << 30) == b.randint(0, 1 << 30)


def test_shapes_rates_and_records_equal():
    assert T.TRACES == J.TRACES
    for frac in np.linspace(0.0, 1.0, 17):
        for shape in T.TRACES:
            assert T.mult_at(T.TRACES[shape], frac) \
                == J.mult_at(J.TRACES[shape], frac)
            assert T.rate_at(frac, 3.0, T.TRACES[shape], T.diurnal_mult) \
                == J.rate_at(frac, 3.0, J.TRACES[shape], J.diurnal_mult)
        assert T.diurnal_mult(frac) == J.diurnal_mult(frac)
    ts = _gen(T, 5, "burst", None)
    rec_t = T.trace_record(5, 4.0, T.TRACES["burst"], 10.0, ts,
                           shape="burst")
    rec_j = J.trace_record(5, 4.0, J.TRACES["burst"], 10.0, ts,
                           shape="burst")
    assert rec_t == rec_j
    assert json.loads(json.dumps(rec_t)) == rec_t
    assert list(T.replay_arrivals(rec_t)) == ts == list(
        J.replay_arrivals(rec_j))
    with pytest.raises(ValueError, match="version"):
        list(T.replay_arrivals(dict(rec_t, version=2)))
