"""The port's API clients (sustaingym_tpu_torch.data.api_clients) with the
JAX tests' fake HTTP layers (tests/test_api_clients.py): no network. The
SGIP chain, fake SGIP -> ``save_monthly_moer`` -> ``build_moer_pack``,
must give the JAX chain's pack bit for bit."""
import datetime as dt
import gzip
import os

import numpy as np
import pandas as pd
import pytest

from sustaingym_tpu.data import api_clients as jac
from sustaingym_tpu.data import ev_etl as jev
from sustaingym_tpu.data import paths as jpaths
from sustaingym_tpu_torch.data import api_clients as ac
from sustaingym_tpu_torch.data import ev_etl as tev
from sustaingym_tpu_torch.data import paths as tpaths
from tests.test_api_clients import FakeACN, FakeSGIP


def test_urls_match_jax():
    assert ac.SGIP_LOGIN_URL == jac.SGIP_LOGIN_URL
    assert ac.SGIP_DATA_URLS == jac.SGIP_DATA_URLS
    assert ac.SGIP_DATA_VERSIONS == jac.SGIP_DATA_VERSIONS
    assert (ac.ACN_API_URL, ac.ACN_PAGE_SIZE) == (jac.ACN_API_URL,
                                                  jac.ACN_PAGE_SIZE)


def test_sgip_historical_and_forecast():
    args = ("2021-02-01T00:00:00+0000", "2021-02-01T01:00:00+0000",
            "SGIP_CAISO_PGE")
    df = ac.get_data_sgip(*args, "historical", http=FakeSGIP())
    assert list(df.columns) == ["moer"] and len(df) == 13
    assert str(df.index.tz) == "UTC"
    pd.testing.assert_frame_equal(
        df, jac.get_data_sgip(*args, "historical", http=FakeSGIP()))

    df = ac.get_data_sgip(*args, "forecasted", http=FakeSGIP())
    assert list(df.columns) == [f"f{i+1}" for i in range(36)]
    pd.testing.assert_frame_equal(
        df, jac.get_data_sgip(*args, "forecasted", http=FakeSGIP()))


def test_sgip_failed_login_raises():
    class NoToken(FakeSGIP):
        def get(self, url, **kw):
            return type("R", (), {"json": lambda self: {"detail": "no"}})()

    with pytest.raises(RuntimeError, match="authentication failed"):
        ac.get_data_sgip("a", "b", "SGIP_CAISO_PGE", "historical",
                         http=NoToken())


def test_save_monthly_moer(tmp_path):
    path = ac.save_monthly_moer(2021, 2, "SGIP_CAISO_PGE", str(tmp_path),
                                fetch=lambda *a, **k: ac.get_data_sgip(
                                    *a, **k, http=FakeSGIP()))
    with gzip.open(path, "rt") as f:
        df = pd.read_csv(f, index_col="time")
    assert "moer" in df.columns and "f36" in df.columns
    assert path.endswith("SGIP_CAISO_PGE_2021-02.csv.gz")


def test_fetch_acn_sessions():
    df = ac.fetch_acn_sessions(
        "caltech", dt.datetime(2021, 6, 1), dt.datetime(2021, 6, 2),
        http=FakeACN())
    assert len(df) == 2
    assert bool(df["claimed"][0]) and not bool(df["claimed"][1])
    assert df["requested_energy (kWh)"][0] == 20.0
    assert df["station_id"].tolist() == ["CA-496", "CA-497"]
    pd.testing.assert_frame_equal(df, jac.fetch_acn_sessions(
        "caltech", dt.datetime(2021, 6, 1), dt.datetime(2021, 6, 2),
        http=FakeACN()))


def test_sgip_to_moer_pack_chain_matches_jax(tmp_path, monkeypatch):
    """Fake SGIP -> save_monthly_moer into <raw>/moer -> build_moer_pack,
    in each package over its own raw root and pack directory: the packs
    are bit-equal, and the port's raw file is the JAX one's byte for
    byte once unzipped."""
    packs = []
    for client, etl, paths, sub in ((ac, tev, tpaths, "port"),
                                    (jac, jev, jpaths, "jax")):
        raw = tmp_path / sub / "raw"
        monkeypatch.setattr(paths, "PACKED_DIR", str(tmp_path / sub / "pk"))
        monkeypatch.setattr(paths, "_DEFAULT_RAW_CANDIDATES", ("", str(raw)))
        client.save_monthly_moer(
            2021, 2, "SGIP_CAISO_PGE", str(raw / "moer"),
            fetch=lambda *a, c=client, **k: c.get_data_sgip(
                *a, **k, http=FakeSGIP()))
        packs.append(etl.build_moer_pack(("2021-02-03", "2021-02-10"),
                                         ba="SGIP_CAISO_PGE", cache=False))
    ours, theirs = packs
    assert ours.shape == (8, 289, 37) and (ours[:, :, 0] > 0.4).all()
    assert ours.tobytes() == theirs.tobytes()
    name = os.path.join("raw", "moer", "SGIP_CAISO_PGE_2021-02.csv.gz")
    with gzip.open(tmp_path / "port" / name) as a, \
            gzip.open(tmp_path / "jax" / name) as b:
        assert a.read() == b.read()
    assert np.isfinite(ours).all()
