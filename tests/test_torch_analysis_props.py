"""Property test: randomly parameterized CLEAN plans of the port produce
zero findings (the reference's ``tests/test_analysis_props.py`` on the
port, on the CPU).

hypothesis draws index / metric / bits / lifecycle / predicate combinations
the hand-picked grid may never have tried; the port's op audit must stay
silent on every one of them, and the stages they capture must be the ones
the reference's engine reports for the same point.
"""

import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.analysis import audit_captures
from repro_torch.analysis import grid as agrid

POINTS = st.builds(
    agrid.GridPoint,
    label=st.just("prop"),
    index=st.sampled_from(["bruteforce", "ivf", "hnsw"]),
    metric=st.sampled_from(["cosine", "l2", "dot"]),
    bits=st.sampled_from([4, 2]),
    lifecycle=st.sampled_from(["static", "mutated"]),
    where=st.booleans(),
)

# The stages each backend's plan reports (``scan`` on IVF / HNSW only for an
# added segment, ``predicate_mask`` only with where=).
_STAGES = {"bruteforce": {"rotate", "scan", "finalize"},
           "ivf": {"rotate", "main", "merge"},
           "hnsw": {"rotate", "main", "merge"}}


@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(point=POINTS)
def test_random_clean_plan_has_zero_findings(point):
    point = agrid.GridPoint(
        label=f"prop/{point.index}/{point.metric}/b{point.bits}/"
              f"{point.lifecycle}{'+where' if point.where else ''}",
        index=point.index, metric=point.metric, bits=point.bits,
        lifecycle=point.lifecycle, where=point.where)
    caps = agrid.collect_captures([point], device="cpu")
    assert caps, "plan observer captured nothing"
    want = set(_STAGES[point.index])
    if point.where:
        want.add("predicate_mask")
    if point.lifecycle == "mutated":
        want.add("scan")
    assert {c.stage for c in caps} == want
    found = audit_captures(caps)
    assert found == [], [f.to_dict() for f in found]
