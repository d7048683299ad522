"""The port's raw-data ETL (sustaingym_tpu_torch.data.{ev_etl,cogen_etl},
utils.xlsx) against the JAX package's on one synthetic raw tree.

The tree is written here, in the reference layout, from a numpy seed:
- ``moer/SGIP_CAISO_SCE_2021-{05,06}.csv.gz``: 5-min rows with a ``time``
  index, columns moer, f1..f36, the months overlapping by an hour;
- ``evcharging/acn_data/caltech/2021-05-01 2021-08-31.csv.gz``: sessions
  with claimed and unclaimed rows, stations in and out of the network,
  next-day and early departures, a day over ``MAX_EVS`` sessions;
- ``cogen/ambients_data/``: the NREL wind CSV, two ERCOT workbooks
  written with ``zipfile`` as SpreadsheetML (shared and inline strings,
  two sheets, a 23-hour day), the Henry Hub CSV with gaps.
Every pack and workbook must be bit-equal between the packages. Both
packages' pack directories, the port's committed-pack directory and both
raw roots point into ``tmp_path``.
"""
import datetime as dt
import gzip
import os
import zipfile
from xml.sax.saxutils import escape

import numpy as np
import pandas as pd
import pytest

from sustaingym_tpu.data import cogen_etl as jcogen
from sustaingym_tpu.data import ev_etl as jev
from sustaingym_tpu.data import paths as jpaths
from sustaingym_tpu.utils import xlsx as jxlsx
from sustaingym_tpu_torch.data import cogen_etl as tcogen
from sustaingym_tpu_torch.data import ev_etl as tev
from sustaingym_tpu_torch.data import paths as tpaths
from sustaingym_tpu_torch.envs.evcharging.sites import load_site
from sustaingym_tpu_torch.utils import xlsx as txlsx

PERIOD = ("2021-05-30", "2021-06-02")
STATIONS = load_site("caltech").station_ids


def _write_moer(root, rng):
    cols = ["moer"] + [f"f{i + 1}" for i in range(36)]
    for month, (a, b) in {5: ("2021-05-29", "2021-06-01 01:00"),
                          6: ("2021-06-01", "2021-06-04")}.items():
        t = pd.date_range(a, b, freq="5min", tz="UTC", name="time")
        df = pd.DataFrame(rng.uniform(0.2, 0.9, (len(t), 37)), index=t,
                          columns=cols)
        path = os.path.join(root, "moer", f"SGIP_CAISO_SCE_2021-{month:02d}"
                            ".csv.gz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with gzip.open(path, "wt") as f:
            df.to_csv(f)


def _write_sessions(root, rng):
    rows = []
    la = "America/Los_Angeles"
    ids = list(STATIONS) + ["XX-1", "XX-2"]
    for day, n in (("2021-05-30", 40), ("2021-05-31", 300),
                   ("2021-06-01", 30), ("2021-06-02", 60),
                   ("2021-06-03", 10)):
        base = pd.Timestamp(day, tz=la)
        for _ in range(n):
            arr = base + pd.Timedelta(minutes=int(rng.integers(0, 20 * 60)))
            dep = arr + pd.Timedelta(minutes=int(rng.integers(5, 10 * 60)))
            est = arr + pd.Timedelta(minutes=int(rng.integers(-60, 10 * 60)))
            rows.append({
                "arrival": arr.tz_convert("UTC"),
                "departure": dep.tz_convert("UTC"),
                "estimated_departure": est.tz_convert("UTC"),
                "requested_energy (kWh)": float(rng.uniform(1.0, 140.0)),
                "station_id": ids[int(rng.integers(0, len(ids)))],
                "claimed": bool(rng.uniform() < 0.8)})
    path = os.path.join(root, "evcharging", "acn_data", "caltech",
                        "2021-05-01 2021-08-31.csv.gz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        pd.DataFrame(rows).to_csv(f, index=False)


_NS = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"


def _col(i):
    return "ABCDE"[i]


def write_xlsx(path, sheets: dict):
    """A SpreadsheetML workbook: strings in even rows shared, in odd rows
    inline; numbers as values."""
    shared: list[str] = []
    files = {}
    for k, (name, rows) in enumerate(sheets.items()):
        cells = []
        for r, row in enumerate(rows):
            out = []
            for c, v in enumerate(row):
                ref = f"{_col(c)}{r + 1}"
                if isinstance(v, str) and r % 2 == 0:
                    shared.append(v)
                    out.append(f'<c r="{ref}" t="s"><v>{len(shared) - 1}'
                               f'</v></c>')
                elif isinstance(v, str):
                    out.append(f'<c r="{ref}" t="inlineStr"><is><t>'
                               f'{escape(v)}</t></is></c>')
                else:
                    out.append(f'<c r="{ref}"><v>{v!r}</v></c>')
            cells.append(f'<row r="{r + 1}">{"".join(out)}</row>')
        files[f"xl/worksheets/sheet{k + 1}.xml"] = (
            f'<worksheet xmlns="{_NS}"><sheetData>{"".join(cells)}'
            f'</sheetData></worksheet>')
    files["xl/workbook.xml"] = (
        f'<workbook xmlns="{_NS}"><sheets>' + "".join(
            f'<sheet name="{escape(n)}" sheetId="{i + 1}"/>'
            for i, n in enumerate(sheets)) + "</sheets></workbook>")
    files["xl/sharedStrings.xml"] = (
        f'<sst xmlns="{_NS}">' + "".join(
            f"<si><t>{escape(s)}</t></si>" for s in shared) + "</sst>")
    with zipfile.ZipFile(path, "w") as zf:
        for name, text in files.items():
            zf.writestr(name, text)


def _price_rows(days, rng, short_day=None):
    rows = [["Delivery Date", "Hour Ending", "Repeated Hour Flag",
             "Settlement Point", "Settlement Point Price"]]
    for day in days:
        hours = 23 if day == short_day else 24
        for h in range(1, hours + 1):
            for point in ("HB_HOUSTON", "HB_NORTH"):
                rows.append([day.strftime("%m/%d/%Y"), f"{h:02d}:00", "N",
                             point, float(np.round(rng.uniform(10, 90), 2))])
    return rows


def _write_cogen(root, rng):
    d = os.path.join(root, "cogen", "ambients_data")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "0_39.97_-128.77_2019_15min.csv"), "w") as f:
        f.write("SiteID,Latitude,Longitude\n")
        f.write("Year,Month,Day,Hour,Minute,wind speed at 100m (m/s)\n")
        for i in range(3000):
            speed = "" if i % 997 == 5 else f"{rng.uniform(0, 31):.3f}"
            f.write(f"2019,1,1,0,0,{speed}\n")
    may = [dt.date(2021, 5, 1) + dt.timedelta(days=i) for i in range(12)]
    jun = [dt.date(2021, 6, 1) + dt.timedelta(days=i) for i in range(3)]
    write_xlsx(os.path.join(d, "rpt.00013060.0000000000000000."
                               "DAMLZHBSPP_2021.xlsx"),
               {"May": _price_rows(may, rng, short_day=may[6]),
                "Jun": _price_rows(jun, rng)})
    jan = [dt.date(2022, 1, 1) + dt.timedelta(days=i) for i in range(4)]
    write_xlsx(os.path.join(d, "rpt.00013060.0000000000000000."
                               "DAMLZHBSPP_2022.xlsx"),
               {"Jan": _price_rows(jan, rng)})
    with open(os.path.join(d, "Henry_Hub_Natural_Gas_Spot_Price.csv"),
              "w") as f:
        f.write("Henry Hub Natural Gas Spot Price\nLink\nSource\n\n"
                "Day,Price\n")
        day = dt.date(2021, 4, 25)
        while day <= dt.date(2022, 2, 3):
            if day.weekday() < 5:
                f.write(f"{day:%m/%d/%Y},{rng.uniform(2, 6):.2f}\n")
            day += dt.timedelta(days=1)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    rng = np.random.default_rng(13)
    _write_moer(root, rng)
    _write_sessions(root, rng)
    _write_cogen(root, rng)
    return root


@pytest.fixture
def dirs(raw, tmp_path, monkeypatch):
    """Both packages' pack directories under tmp_path (one each), the
    port's committed packs at an absent directory there (so that the port
    builds every pack the JAX package builds), both raw roots at the
    synthetic tree."""
    for paths, sub in ((jpaths, "jax"), (tpaths, "port")):
        monkeypatch.setattr(paths, "PACKED_DIR", str(tmp_path / sub))
        monkeypatch.setattr(paths, "_DEFAULT_RAW_CANDIDATES", ("", raw))
    monkeypatch.setattr(tpaths, "COMMITTED_DIR", str(tmp_path / "committed"))
    return tmp_path


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_read_workbook_matches_jax(raw):
    d = os.path.join(raw, "cogen", "ambients_data")
    for year in (2021, 2022):
        path = os.path.join(d, f"rpt.00013060.0000000000000000."
                               f"DAMLZHBSPP_{year}.xlsx")
        ours = txlsx.read_workbook(path)
        assert ours == jxlsx.read_workbook(path)
        assert txlsx.sheet_names(path) == jxlsx.sheet_names(path) \
            == list(ours)
    first = txlsx.read_workbook(os.path.join(
        d, "rpt.00013060.0000000000000000.DAMLZHBSPP_2021.xlsx"))["May"]
    assert first[1][:4] == ["05/01/2021", "01:00", "N", "HB_HOUSTON"]
    assert isinstance(first[2][4], float)


def test_moer_pack_bit_equal(dirs):
    ours = tev.build_moer_pack(PERIOD)
    _equal(ours, jev.build_moer_pack(PERIOD))
    assert ours.shape == (4, 289, 37) and (ours[:, :288] > 0).all()
    # cached under the JAX file name, and read back
    assert os.path.exists(dirs / "port" / "moer_SGIP_CAISO_SCE_2021-05-30_"
                          "2021-06-02.npz")
    _equal(tev.build_moer_pack(PERIOD), ours)


@pytest.mark.parametrize("unclaimed", [False, True])
def test_trace_pack_bit_equal(dirs, unclaimed):
    ours = tev.build_trace_pack("caltech", PERIOD, STATIONS,
                                use_unclaimed=unclaimed, cache=False)
    theirs = jev.build_trace_pack("caltech", PERIOD, STATIONS,
                                  use_unclaimed=unclaimed, cache=False)
    for k in ("ev_data", "ev_station", "ev_mask"):
        _equal(ours[k], theirs[k])
    n = ours["ev_mask"].sum(1)
    assert n[1] == tev.MAX_EVS and 0 < n.min()
    assert ours["ev_data"][..., 3].max() == 100.0     # capped


def test_synthesize_operating_data_bit_equal():
    times, op = tcogen.synthesize_operating_data()
    jtimes, jop = jcogen.synthesize_operating_data()
    assert times == jtimes
    _equal(op, jop)


@pytest.mark.parametrize("wind", [0.0, 37.5])
def test_ambients_pack_bit_equal(dirs, wind):
    ours = tcogen.build_ambients_pack(wind)
    _equal(ours, jcogen.build_ambients_pack(wind))
    # the valid days of the price files (not the 23-hour day, the first
    # and last dropped)
    assert ours.shape == (16, 96, 7) and np.isfinite(ours).all()
    assert os.path.exists(dirs / "port" / f"cogen_ambients_wind={wind}.npz")
    assert tcogen.load_energy_prices() == jcogen.load_energy_prices()
    assert tcogen.load_gas_prices() == jcogen.load_gas_prices()
    _equal(tcogen.load_wind_capacity_factors(),
           jcogen.load_wind_capacity_factors())


def test_ambients_pack_reads_the_shipped_pack():
    shipped = np.load(os.path.join(tpaths.COMMITTED_DIR,
                                   "cogen_ambients_wind=100.0.npz"))
    _equal(tcogen.build_ambients_pack(100.0), shipped["ambients"])


def test_requested_energy_cap_on_a_cached_pack(dirs):
    """The cap applies to a cached pack: 40 on the pack built at 100 is a
    fresh build at 40, where the JAX cache returns the pack at 100 (its
    cache key lacks the cap). A cap over 100 is built from the raw
    sessions and cached under a name with its cap."""
    kw = dict(site="caltech", date_period=PERIOD, station_ids=STATIONS)
    full = tev.build_trace_pack(**kw)                  # cached at 100
    assert os.path.exists(dirs / "port" / "evtrace_caltech_2021-05-30_"
                          "2021-06-02_0.npz")
    jev.build_trace_pack(**kw)                          # the JAX cache
    fresh = tev.build_trace_pack(**kw, requested_energy_cap=40.0,
                                 cache=False)
    cached = tev.build_trace_pack(**kw, requested_energy_cap=40.0)
    theirs = jev.build_trace_pack(**kw, requested_energy_cap=40.0)
    for k in ("ev_data", "ev_station", "ev_mask"):
        _equal(cached[k], fresh[k])
        _equal(theirs[k], full[k])
    assert fresh["ev_data"][..., 3].max() == 40.0
    assert not np.array_equal(theirs["ev_data"], fresh["ev_data"])
    # nothing written for the capped read
    assert not os.path.exists(dirs / "port" / "evtrace_caltech_2021-05-30_"
                              "2021-06-02_0_cap=40.0.npz")
    wide = tev.build_trace_pack(**kw, requested_energy_cap=150.0)
    assert os.path.exists(dirs / "port" / "evtrace_caltech_2021-05-30_"
                          "2021-06-02_0_cap=150.0.npz")
    _equal(wide["ev_data"], tev.build_trace_pack(
        **kw, requested_energy_cap=150.0, cache=False)["ev_data"])
    assert wide["ev_data"][..., 3].max() > 100.0


def test_env_applies_the_cap_on_real_traces():
    """make_params passes the site's stations and its cap: the shipped
    pack (built at 100) with the cap applied."""
    from sustaingym_tpu_torch.envs.evcharging import make_params
    full = tev.build_trace_pack("caltech", "Summer 2021", STATIONS)
    p = make_params(device="cpu", requested_energy_cap=20.0)
    n = p.n_stations
    req = p.step_table[:, :, 2 * n:3 * n]
    assert float(req.max()) == 20.0
    assert float(full["ev_data"][..., 3].max()) > 20.0


def test_missing_raw_root_names_the_files(tmp_path, monkeypatch):
    monkeypatch.setattr(tpaths, "PACKED_DIR", str(tmp_path))
    monkeypatch.setattr(tpaths, "_DEFAULT_RAW_CANDIDATES", ("",))
    with pytest.raises(FileNotFoundError, match="SGIP_CAISO_SCE_2021-06"):
        tev.build_moer_pack(PERIOD)
    with pytest.raises(FileNotFoundError,
                       match="acn_data/caltech/2021-05-01 2021-08-31"):
        tev.build_trace_pack("caltech", PERIOD, STATIONS)
    with pytest.raises(FileNotFoundError, match="DAMLZHBSPP_2022.xlsx"):
        tcogen.build_ambients_pack(37.5)
    # the shipped tree, found by the committed fallback: a cap over the
    # shipped packs' 100 names the raw sessions and both places looked in
    shipped = tev.build_trace_pack("caltech", "Summer 2021", STATIONS)
    assert shipped["ev_mask"].any()
    with pytest.raises(FileNotFoundError, match="raw ETL inputs") as err:
        tev.build_trace_pack("caltech", "Summer 2021", STATIONS,
                             requested_energy_cap=150.0)
    for place in (tmp_path, tpaths.COMMITTED_DIR):
        assert str(place) in str(err.value)
