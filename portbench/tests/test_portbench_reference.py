import numpy as np
import pytest

from conftest import cell


def _table(svc, path, status, lat):
    n = len(svc)
    return {
        "rows": n,
        "cols": {
            "service": (np.asarray(svc, np.int32),),
            "req_path": (np.asarray(path, np.int32),),
            "resp_status": (np.asarray(status, np.int64),),
            "latency_ns": (np.asarray(lat, np.int64),),
        },
        "dicts": {"service": ["a", "b"], "req_path": ["/x", "/y"]},
    }


@pytest.fixture(scope="module")
def default():
    return cell("pem_default.http_stats")


@pytest.fixture(scope="module")
def refs(default):
    return {"http_stats": default.reference}


# Hand-computed: rows with status >= 400 drop out of http_stats.
SMALL = _table(svc=[0, 0, 0, 1, 1, 0], path=[0, 0, 1, 1, 1, 0],
               status=[200, 404, 200, 500, 200, 200], lat=[10, 99, 30, 7, 5, 20])


def test_http_stats_reference_by_hand(refs):
    assert refs["http_stats"].answer(SMALL) == {
        ("a", "/x"): (2, 15.0, 20.0),
        ("a", "/y"): (1, 30.0, 30.0),
        ("b", "/y"): (1, 5.0, 5.0),
    }


def test_the_reference_passes_itself_and_the_float32_control_fails(default):
    from portbench import run

    ref = default.reference
    data = run.make_data(default, 4, 1 << 16)
    prep = ref.prepare(data)
    own = ref.compare([ref.as_program_output(ref.answer(data))], prep)
    assert all(own[k] <= ref.LIMITS[k] for k in ref.LIMITS), own
    ctl = ref.compare([ref.as_program_output(ref.answer(data, np.float32))], prep)
    assert any(ctl[k] > ref.LIMITS[k] for k in ref.LIMITS), ctl


def test_http_stats_compare_counts_each_fault(refs):
    ref = refs["http_stats"]
    good = ref.as_program_output(ref.answer(SMALL))
    prep = ref.prepare(SMALL)
    assert ref.compare([good], prep) == {"exact_mismatch": 0.0, "mean_rel_err": 0.0}
    bad = {k: v.copy() for k, v in good.items()}
    bad["n"][0] += 1
    bad["lat_mean"][1] = np.nan
    got = ref.compare([good, bad], prep)
    assert got["exact_mismatch"] == 1.0 and got["mean_rel_err"] == float("inf")
    missing = {k: v[1:] for k, v in good.items()}
    assert ref.compare([missing], prep)["exact_mismatch"] == 1.0
