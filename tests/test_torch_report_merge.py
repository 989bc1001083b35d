"""``RaptorReport.merge`` / ``merge_all`` of the port against the
reference's (``tests/test_report_merge.py``, case by case): the same
statistics, given as numpy arrays to both packages, merge to the same
numbers. Tolerance: equal (integer sums and float maxima are exact). The
port's counts are int64 whatever they were given as; the reference's are
int32 without x64 (ROADMAP Queue C).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.core.memmode import RaptorReport as JReport

import repro_torch.core as tc
from repro_torch.core.memmode import RaptorReport


def _report(locs, flags, max_rel, op_counts):
    return RaptorReport(tuple(locs), torch.tensor(flags, dtype=torch.int64),
                        torch.tensor(max_rel, dtype=torch.float32),
                        torch.tensor(op_counts, dtype=torch.int64))


def _jreport(locs, flags, max_rel, op_counts):
    return JReport(tuple(locs), jnp.asarray(flags, jnp.int32),
                   jnp.asarray(max_rel, jnp.float32),
                   jnp.asarray(op_counts, jnp.int32))


def both(*fields):
    return _jreport(*fields), _report(*fields)


def lists(rep):
    return [np.asarray(jax.device_get(x)).tolist() if not
            isinstance(x, torch.Tensor) else x.tolist()
            for x in (rep.flags, rep.max_rel, rep.op_counts)]


def test_merge_sums_and_maxes():
    ja, ta = both(["l0", "l1"], [3, 0], [0.5, 0.0], [10, 4])
    jb, tb = both(["l0", "l1"], [1, 2], [0.25, 1.5], [10, 4])
    m = ta.merge(tb)
    assert m.locations == ("l0", "l1") == ja.merge(jb).locations
    assert lists(m) == lists(ja.merge(jb)) == [[4, 2], [0.5, 1.5], [20, 8]]
    assert m.flags.dtype == m.op_counts.dtype == torch.int64
    assert m.max_rel.dtype == torch.float32


def test_merge_mismatched_locations_raises():
    for mk in (_jreport, _report):
        a = mk(["l0", "l1"], [1, 1], [0.1, 0.1], [2, 2])
        b = mk(["l0", "OTHER"], [1, 1], [0.1, 0.1], [2, 2])
        with pytest.raises(ValueError, match="location tables differ"):
            a.merge(b)
        c = mk(["l0"], [1], [0.1], [2])
        with pytest.raises(ValueError, match="location tables differ"):
            a.merge(c)


def test_merge_all_empty_raises():
    for cls in (JReport, RaptorReport):
        with pytest.raises(ValueError, match="at least one report"):
            cls.merge_all([])


def test_merge_all_single_is_identity():
    for mk, cls in ((_jreport, JReport), (_report, RaptorReport)):
        a = mk(["l0"], [5], [0.75], [9])
        assert cls.merge_all([a]) is a


def test_merge_all_many_is_left_fold():
    fields = [(["l0", "l1"], [i, 1], [0.1 * i, 0.2], [i, i])
              for i in range(1, 5)]
    jm = JReport.merge_all([_jreport(*f) for f in fields])
    tm = RaptorReport.merge_all([_report(*f) for f in fields])
    assert lists(tm) == lists(jm)
    assert tm.flags.tolist() == [1 + 2 + 3 + 4, 4]
    assert tm.max_rel.tolist() == pytest.approx([0.4, 0.2])
    assert tm.op_counts.tolist() == [10, 10]


def test_merge_empty_sentinel_reports():
    """A computation with no truncated locations gives the one-row sentinel
    report; merging two of them stays consistent."""
    _, jrep = jc.memtrace(lambda x: x * 2.0, jc.TruncationPolicy(rules=()),
                          threshold=1e-3)(jnp.ones((4,), jnp.float32))
    _, rep = tc.memtrace(lambda x: x * 2.0, tc.TruncationPolicy(rules=()),
                         threshold=1e-3)(torch.ones(4))
    assert rep.locations == jrep.locations == ("<no truncated locations>",)
    m = rep.merge(rep)
    assert m.locations == rep.locations
    assert lists(m) == lists(jrep.merge(jrep)) == [[0], [0.0], [0]]


def test_merge_numpy_inputs_promote():
    """Host-side merging accepts numpy statistics (e.g. read back from
    another process)."""
    def numpy_report(cls):
        return cls(("l0",), np.asarray([2]), np.asarray([0.5], np.float32),
                   np.asarray([7]))

    jm = JReport.merge_all([numpy_report(JReport),
                            _jreport(["l0"], [3], [0.125], [5])])
    tm = RaptorReport.merge_all([numpy_report(RaptorReport),
                                 _report(["l0"], [3], [0.125], [5])])
    assert lists(tm) == lists(jm) == [[5], [0.5], [12]]
    assert tm.flags.dtype == torch.int64
