"""Env-knob parsing (utils/tuning.py). The knobs select between
implementations whose equivalence is pinned by their own tests
(test_voxelize / test_face_stats / test_cluster); here we only pin the
parsing contract an A/B run relies on."""

import pytest

from fccf_pcr_tpu.utils.tuning import env_bool, env_choice, env_int


def test_env_choice(monkeypatch):
    monkeypatch.delenv("K", raising=False)
    assert env_choice("K", "auto", ("auto", "x")) == "auto"
    monkeypatch.setenv("K", "x")
    assert env_choice("K", "auto", ("auto", "x")) == "x"
    monkeypatch.setenv("K", "bogus")
    with pytest.raises(ValueError):
        env_choice("K", "auto", ("auto", "x"))


def test_env_int(monkeypatch):
    monkeypatch.delenv("K", raising=False)
    assert env_int("K", 7) == 7
    monkeypatch.setenv("K", "8192")
    assert env_int("K", 7) == 8192
    monkeypatch.setenv("K", "")
    assert env_int("K", 7) == 7


def test_env_bool(monkeypatch):
    monkeypatch.delenv("K", raising=False)
    assert env_bool("K", False) is False
    for v, want in [("1", True), ("true", True), ("on", True),
                    ("0", False), ("no", False)]:
        monkeypatch.setenv("K", v)
        assert env_bool("K", False) is want
    monkeypatch.setenv("K", "maybe")
    with pytest.raises(ValueError):
        env_bool("K", False)
