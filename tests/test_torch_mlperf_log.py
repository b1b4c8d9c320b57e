"""The port's MLPerf logger against the ``:::MLLOG`` contract of
``tests/test_mlperf_log.py`` and against the JAX package's logger: the
same records, key by key, but for the time and the caller's line."""

import json

import pytest

from deepcam_tpu_torch.obs.mlperf_log import MLPerfLogger, parse_mllog


def _log_run(cls, path):
    logger = cls(path, "deepcam", "TestOrg", barrier_fn=lambda: None)
    logger.log_start(key="init_start", sync=True)
    logger.log_event(key="seed", value=333)
    logger.log_event(key="global_batch_size", value=16)
    logger.log_end(key="init_stop", sync=True)
    logger.log_start(key="run_start", sync=True)
    logger.log_event(key="train_loss", value=0.5, metadata={"epoch_num": 1, "step_num": 10})
    logger.log_end(key="run_stop", sync=True, metadata={"status": "success"})
    logger.close()
    return parse_mllog(path)


def test_header_and_key_contract(tmp_path):
    records = _log_run(MLPerfLogger, str(tmp_path / "logs" / "run.log"))
    keys = [r["key"] for r in records]
    assert keys == ["submission_benchmark", "submission_org", "submission_division",
                    "submission_status", "submission_platform", "init_start", "seed",
                    "global_batch_size", "init_stop", "run_start", "train_loss", "run_stop"]
    by_key = {r["key"]: r for r in records}
    assert by_key["submission_division"]["value"] == "closed"
    assert by_key["submission_status"]["value"] == "onprem"
    assert by_key["submission_platform"]["value"] == "1xSUBMISSION_PLATFORM_PLACEHOLDER"
    assert by_key["seed"]["value"] == 333
    assert by_key["init_start"]["event_type"] == "INTERVAL_START"
    assert by_key["init_stop"]["event_type"] == "INTERVAL_END"
    assert by_key["train_loss"]["event_type"] == "POINT_IN_TIME"
    assert by_key["train_loss"]["metadata"]["step_num"] == 10
    assert by_key["run_stop"]["metadata"]["status"] == "success"
    for i, r in enumerate(records):  # the header comes from the constructor
        assert r["metadata"]["file"] == ("mlperf_log.py" if i < 5 else "test_torch_mlperf_log.py")
        assert isinstance(r["metadata"]["lineno"], int) and isinstance(r["time_ms"], int)
        assert r["namespace"] == ""


def test_records_match_the_jax_logger(tmp_path):
    from deepcam_tpu.obs.mlperf_log import MLPerfLogger as JaxLogger

    def strip(records):
        return [{k: (v if k != "metadata" else {m: x for m, x in v.items() if m != "lineno"})
                 for k, v in r.items() if k != "time_ms"} for r in records]

    port = _log_run(MLPerfLogger, str(tmp_path / "p.log"))
    ref = _log_run(JaxLogger, str(tmp_path / "j.log"))
    assert strip(port) == strip(ref)


def test_wire_format_and_barrier(tmp_path):
    calls = []
    log = str(tmp_path / "run.log")
    logger = MLPerfLogger(log, barrier_fn=lambda: calls.append(1))
    n = len(calls)  # the constructor's barrier
    logger.log_event(key="cache_clear")
    logger.log_end(key="run_stop", sync=True)
    logger.close()
    assert n == 1 and len(calls) == 2
    with open(log) as f:
        lines = f.read().splitlines()
    assert len(lines) == 7
    for line in lines:
        assert line.startswith(":::MLLOG ")
        json.loads(line[len(":::MLLOG "):])


def test_default_barrier_is_the_collectives_barrier(tmp_path, monkeypatch):
    """Without ``barrier_fn`` the logger's barrier is
    ``parallel/collectives.py:barrier``: the constructor's and each
    ``sync=True`` key's."""
    from deepcam_tpu_torch.parallel import collectives

    calls = []
    monkeypatch.setattr(collectives, "barrier", lambda: calls.append(1))
    logger = MLPerfLogger(str(tmp_path / "b.log"))
    logger.log_event(key="cache_clear")
    logger.log_start(key="run_start", sync=True)
    logger.close()
    assert len(calls) == 2


def test_default_barrier_is_a_no_op_in_one_process(tmp_path):
    logger = MLPerfLogger(str(tmp_path / "x.log"))
    logger.log_start(key="run_start", sync=True)  # no process group: returns
    logger.close()
    assert [r["key"] for r in parse_mllog(str(tmp_path / "x.log"))][-1] == "run_start"


@pytest.mark.parametrize("stdout", [False, True])
def test_stdout_echo(tmp_path, capsys, stdout):
    logger = MLPerfLogger(str(tmp_path / "s.log"), stdout=stdout, barrier_fn=lambda: None)
    logger.close()
    out = capsys.readouterr().out
    assert (out.count(":::MLLOG ") == 5) == stdout
