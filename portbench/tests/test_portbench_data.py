import numpy as np
import pytest

from portbench import run

from conftest import ROWS, cell


@pytest.fixture(scope="module")
def default():
    return cell("pem_default.http_stats")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**64 + 3, -1])
def test_a_seed_gives_the_same_data(default, seed):
    a = run.make_data(default, seed, ROWS)
    b = run.make_data(default, seed, ROWS)
    assert a["rows"] == b["rows"] == ROWS
    assert a["dicts"] == b["dicts"]
    for col, planes in a["cols"].items():
        for p, q in zip(planes, b["cols"][col]):
            assert len(p) == ROWS
            np.testing.assert_array_equal(p, q)


def test_seeds_differ_in_draws_not_in_sizes(default):
    a = run.make_data(default, 1, ROWS)
    b = run.make_data(default, 2, ROWS)
    assert not np.array_equal(a["cols"]["latency_ns"][0], b["cols"]["latency_ns"][0])
    for col in a["cols"]:
        assert [p.dtype for p in a["cols"][col]] == [p.dtype for p in b["cols"][col]]
        assert [p.shape for p in a["cols"][col]] == [p.shape for p in b["cols"][col]]


def test_every_request_is_to_one_of_the_configured_endpoints(default):
    d = run.make_data(default, 11, ROWS)
    svc = np.asarray(d["dicts"]["service"])[d["cols"]["service"][0]]
    path = np.asarray(d["dicts"]["req_path"])[d["cols"]["req_path"][0]]
    pairs = {tuple(p) for p in default.config["endpoints"]}
    assert set(zip(svc, path)) == pairs  # each endpoint drawn, none other
    assert len(pairs) == 15 and len(d["dicts"]["service"]) == 9
    pod = np.asarray(d["dicts"]["pod"])[d["cols"]["pod"][0]]
    assert all(p.startswith(s + "-") for p, s in zip(pod[:1000], svc[:1000]))


def test_config_rows_fill_the_http_events_budget(default):
    cfg = default.config
    assert sum(cfg["columns"].values()) == cfg["row_bytes"] == 68
    assert cfg["table_bytes"] == 1280 * 2**20 * 40 // 100
    assert cfg["rows"] == cfg["table_bytes"] // cfg["row_bytes"] == 7_895_160
