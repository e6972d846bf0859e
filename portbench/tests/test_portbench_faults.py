"""A whole run of the cell, on the CPU at a small size with the chip look
skipped, judges a sound decode correct and each fault the cell can have
not correct: an answer altered where it is produced, half of the batch
left out (answered with the other half), and a request that fails."""

import pytest

from portbench.tests.small_run import run

NAME = "vardct_epf2_3mp"
SIZE = {"height": 256, "width": 512}


@pytest.fixture(autouse=True)
def stream_cache(tmp_path, monkeypatch):
    from portbench.streams import pool

    monkeypatch.setattr(pool, "CACHE", str(tmp_path))


def port_decode():
    from jxl_oxide_tpu_torch.serving import decode_batch_stacked

    return decode_batch_stacked


def test_a_sound_run_is_correct():
    result, limit = run(NAME, SIZE)
    assert result["correct"] is True
    assert result["checks"]["max_abs_gap"]["value"] <= limit
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"decode_mp_s", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("where", ["first pixel", "one block's middle"])
def test_an_answer_altered_where_it_is_produced(where):
    decode = port_decode()

    def altered(streams, **kw):
        outs = decode(streams, **kw)
        for o in outs:
            if where == "first pixel":
                o[0, 0, 0] += 0.01
            else:
                o[100, 204, 1] -= 0.002
        return outs

    result, limit = run(NAME, SIZE, altered)
    assert result["correct"] is False
    assert result["checks"]["max_abs_gap"]["value"] > limit


def test_half_of_the_batch_left_out():
    decode = port_decode()

    def half(streams, **kw):
        outs = decode(streams[: len(streams) // 2], **kw)
        return outs + outs

    result, _ = run(NAME, SIZE, half)
    assert result["correct"] is False


def test_a_failed_request():
    decode = port_decode()
    calls = []

    def flaky(streams, **kw):
        calls.append(1)
        if len(calls) % 5 == 0:
            raise RuntimeError("planted")
        return decode(streams, **kw)

    result, _ = run(NAME, SIZE, flaky)
    assert result["correct"] is False and result["failed"] > 0
    assert result["failed"] % 4 == 0
