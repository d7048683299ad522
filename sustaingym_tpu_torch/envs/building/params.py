"""Host-side parameter compiler for BuildingEnv.

A NumPy copy of ``sustaingym_tpu.envs.building.params``: it compiles an
ASHRAE prototype-building HTM zone table and a TMY3 EPW weather file into
the continuous-time RC matrices, the zero-order-hold discretisation and the
year-long exogenous weather and occupancy series. Every array it returns
is bit-equal to the JAX package's on the same files
(``tests/test_torch_building.py``); all heavy work happens once on the
host, and the per-step path is one small matrix product on the device.
"""
from __future__ import annotations

import io
import math
import os
from typing import Any, NamedTuple, Sequence

import numpy as np

from ...data.paths import raw_path
from ...utils.epw import read_epw


class Ufactor(NamedTuple):
    """Thermal transmittance (W/m^2-K) of building surfaces."""
    intwall: float
    floor: float
    outwall: float
    roof: float
    ceiling: float
    groundfloor: float
    window: float


class Zone(NamedTuple):
    name: str
    zaxis: float
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: float
    zmax: float
    floor_area: float
    exterior_gross_area: float
    exterior_window_area: float
    ind: int


# Building type -> (HTM file, U-factors): Public Building Energy Codes
# Program values, as in the JAX package.
BUILDINGS: dict[str, tuple[str, Ufactor]] = {
    "ApartmentHighRise": ("ASHRAE901_ApartmentHighRise_STD2019_Tucson.table.htm",
                          Ufactor(6.299, 3.285, 0.384, 0.228, 3.839, 0.287, 2.786)),
    "ApartmentMidRise": ("ASHRAE901_ApartmentMidRise_STD2019_Tucson.table.htm",
                         Ufactor(6.299, 3.285, 0.384, 0.228, 3.839, 0.287, 2.786)),
    "Hospital": ("ASHRAE901_Hospital_STD2019_Tucson.table.htm",
                 Ufactor(6.299, 3.839, 0.984, 0.228, 3.839, 3.285, 2.615)),
    "HotelLarge": ("ASHRAE901_HotelLarge_STD2019_Tucson.table.htm",
                   Ufactor(6.299, 0.228, 0.984, 0.228, 0.228, 2.705, 2.615)),
    "HotelSmall": ("ASHRAE901_HotelSmall_STD2019_Tucson.table.htm",
                   Ufactor(6.299, 3.839, 0.514, 0.228, 3.839, 0.1573, 2.615)),
    "OfficeLarge": ("ASHRAE901_OfficeLarge_STD2019_Tucson.table.htm",
                    Ufactor(6.299, 3.839, 0.984, 0.228, 4.488, 3.839, 2.615)),
    "OfficeMedium": ("ASHRAE901_OfficeMedium_STD2019_Tucson.table.htm",
                     Ufactor(6.299, 3.839, 0.514, 0.228, 4.488, 0.319, 2.615)),
    "OfficeSmall": ("ASHRAE901_OfficeSmall_STD2019_Tucson.table.htm",
                    Ufactor(6.299, 3.839, 0.514, 0.228, 4.488, 0.319, 2.615)),
    "OutPatientHealthCare": ("ASHRAE901_OutPatientHealthCare_STD2019_Tucson.table.htm",
                             Ufactor(6.299, 3.839, 0.514, 0.228, 3.839, 0.5650e-02, 2.615)),
    "RestaurantFastFood": ("ASHRAE901_RestaurantFastFood_STD2019_Tucson.table.htm",
                           Ufactor(6.299, 0.158, 0.547, 4.706, 0.158, 0.350, 2.557)),
    "RestaurantSitDown": ("ASHRAE901_RestaurantSitDown_STD2019_Tucson.table.htm",
                          Ufactor(6.299, 0.158, 0.514, 4.706, 0.158, 0.194, 2.557)),
    "RetailStandalone": ("ASHRAE901_RetailStandalone_STD2019_Tucson.table.htm",
                         Ufactor(6.299, 0.047, 0.984, 0.228, 0.228, 0.047, 3.695)),
    "RetailStripmall": ("ASHRAE901_RetailStripmall_STD2019_Tucson.table.htm",
                        Ufactor(6.299, 0.1125, 0.514, 0.228, 0.228, 0.1125, 3.695)),
    "SchoolPrimary": ("ASHRAE901_SchoolPrimary_STD2019_Tucson.table.htm",
                      Ufactor(6.299, 0.144, 0.514, 0.228, 0.228, 0.144, 2.672)),
    "SchoolSecondary": ("ASHRAE901_SchoolSecondary_STD2019_Tucson.table.htm",
                        Ufactor(6.299, 3.839, 0.514, 0.228, 3.839, 0.144, 2.672)),
    "Warehouse": ("ASHRAE901_Warehouse_STD2019_Tucson.table.htm",
                  Ufactor(0.774, 0.1926, 1.044, 0.5892, 10.06, 0.1926, 2.557)),
}

# Monthly ground temperature (deg C) per city, from the building HTM
# "Site:GroundTemperature:FCfactorMethod" tables.
GROUND_TEMP: dict[str, list[float]] = {
    "Albuquerque": [13.7, 7.0, 2.1, 2.6, 4.3, 8.8, 13.9, 17.8, 23.2, 25.6, 24.1, 20.5],
    "Atlanta": [16.0, 11.9, 7.7, 4.0, 7.9, 13.8, 17.2, 20.8, 24.8, 26.1, 26.5, 22.5],
    "Buffalo": [9.7, 6.0, -2.2, -3.4, -4.2, 2.7, 7.5, 13.7, 18.6, 22.0, 20.7, 16.5],
    "Denver": [7.1, 3.0, -1.0, 0.8, -0.2, 4.8, 6.1, 13.7, 22.2, 22.7, 21.7, 18.5],
    "Dubai": [29.5, 25.5, 21.1, 19.2, 20.8, 23.1, 26.5, 31.4, 33.0, 35.1, 35.3, 32.5],
    "ElPaso": [18.3, 11.2, 6.8, 8.1, 10.3, 12.5, 19.2, 23.8, 27.9, 27.5, 26.3, 23.4],
    "Fairbanks": [-3.1, 17.7, 19.3, 17.6, 15.4, 10.3, 0.7, 10.6, 16.0, 16.9, 14.2, 6.7],
    "GreatFalls": [8.6, 2.8, 4.1, 8.8, 2.2, 0.3, 6.7, 10.1, 16.5, 20.6, 19.2, 14.7],
    "HoChiMinh": [26.9, 26.7, 26.0, 26.4, 27.5, 28.3, 29.2, 29.0, 28.9, 27.2, 27.5, 27.6],
    "Honolulu": [26.2, 24.8, 23.7, 22.5, 22.8, 23.2, 23.8, 25.2, 25.9, 26.9, 27.1, 26.9],
    "InternationalFalls": [5.4, 2.0, 14.6, 16.9, 11.5, 6.2, 4.0, 13.4, 18.0, 19.7, 17.9, 12.3],
    "NewDelhi": [25.1, 19.6, 14.5, 13.4, 17.0, 22.4, 29.1, 33.0, 33.6, 31.7, 30.0, 28.7],
    "NewYork": [14.0, 7.3, 3.3, 1.2, -0.2, 5.6, 10.9, 16.1, 21.7, 25.0, 24.8, 19.9],
    "PortAngeles": [9.3, 6.7, 4.1, 4.2, 4.2, 5.9, 9.0, 10.0, 13.3, 15.0, 15.7, 13.4],
    "Rochester": [7.4, 0.0, 7.6, 12.6, 7.7, 0.3, 7.0, 14.2, 19.2, 20.9, 20.0, 15.4],
    "SanDiego": [18.8, 14.3, 13.6, 13.2, 13.3, 12.6, 15.3, 15.6, 17.7, 19.4, 19.7, 18.5],
    "Seattle": [11.4, 8.1, 5.4, 4.5, 5.8, 8.3, 10.9, 13.0, 15.6, 17.7, 18.8, 15.1],
    "Tampa": [24.2, 18.9, 15.7, 13.6, 15.5, 17.1, 21.2, 26.9, 27.6, 27.9, 27.4, 26.2],
    "Tucson": [20.9, 15.4, 11.9, 14.8, 12.7, 15.4, 23.3, 26.3, 31.2, 30.4, 29.8, 27.8],
}

# Climate name -> TMY3 EPW file.
WEATHER: dict[str, str] = {
    "Very_Hot_Humid": "USA_HI_Honolulu.Intl.AP.911820_TMY3.epw",
    "Hot_Humid": "USA_FL_Tampa-MacDill.AFB.747880_TMY3.epw",
    "Hot_Dry": "USA_AZ_Tucson-Davis-Monthan.AFB.722745_TMY3.epw",
    "Warm_Humid": "USA_GA_Atlanta-Hartsfield.Jackson.Intl.AP.722190_TMY3.epw",
    "Warm_Dry": "USA_TX_El.Paso.Intl.AP.722700_TMY3.epw",
    "Warm_Marine": "USA_CA_San.Deigo-Brown.Field.Muni.AP.722904_TMY3.epw",
    "Mixed_Humid": "USA_NY_New.York-John.F.Kennedy.Intl.AP.744860_TMY3.epw",
    "Mixed_Dry": "USA_NM_Albuquerque.Intl.Sunport.723650_TMY3.epw",
    "Mixed_Marine": "USA_WA_Seattle-Tacoma.Intl.AP.727930_TMY3.epw",
    "Cool_Humid": "USA_NY_Buffalo.Niagara.Intl.AP.725280_TMY3.epw",
    "Cool_Dry": "USA_CO_Denver-Aurora-Buckley.AFB.724695_TMY3.epw",
    "Cool_Marine": "USA_WA_Port.Angeles-William.R.Fairchild.Intl.AP.727885_TMY3.epw",
    "Cold_Humid": "USA_MN_Rochester.Intl.AP.726440_TMY3.epw",
    "Cold_Dry": "USA_MT_Great.Falls.Intl.AP.727750_TMY3.epw",
    "Very_Cold": "USA_MN_International.Falls.Intl.AP.727470_TMY3.epw",
    "Subarctic/Arctic": "USA_AK_Fairbanks.Intl.AP.702610_TMY3.epw",
}

DAYS_PER_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)

AIR_DENSITY = 1.225             # kg/m^3
SPECIFIC_HEAT_AIR = 1000.0      # J/kg-K
OCCU_COEF_LINEAR = 7.139322     # W/degC, EnergyPlus engineering reference p.1299


# ---------------------------------------------------------------------------
# HTM zone-table parsing
# ---------------------------------------------------------------------------

# Within each 32-line zone record of the EnergyPlus tabular-HTM "Zone
# Information" table, values live at these fixed line offsets (counted
# from the table's heading line).
_RECORD_LEN = 32
_FIELD_OFFSETS: dict[int, str] = {
    35: "name", 42: "zaxis", 46: "xmin", 47: "xmax", 48: "ymin", 49: "ymax",
    50: "zmin", 51: "zmax", 56: "floor_area", 58: "exterior_gross_area",
    59: "exterior_window_area",
}


def _cell_value(line: str) -> str:
    """Extracts the text of an HTM `<td>` cell line."""
    return line[22:-6]


def parse_zones(path_or_file: str | io.TextIOBase
                ) -> tuple[list[list[Zone]], int, list[Zone]]:
    """Parses the "Zone Information" table of an EnergyPlus tabular HTM file.

    Returns (layers, n, zones) with zones sorted by z-axis and grouped into
    floor layers (equal z-axis).
    """
    if isinstance(path_or_file, str):
        with open(path_or_file) as f:
            lines = f.readlines()
    else:
        lines = path_or_file.readlines()

    records: list[dict[str, Any]] = []
    in_table = False
    count = 0
    current: dict[str, Any] = {}
    for line in lines:
        count += 1
        if "Zone Internal Gains Nominal" in line:
            in_table = False
        if in_table:
            rel = count
            for offset, field in _FIELD_OFFSETS.items():
                if rel >= offset and (rel - offset) % _RECORD_LEN == 0:
                    raw = _cell_value(line)
                    current[field] = raw if field == "name" else float(raw)
                    if field == "exterior_window_area":
                        records.append(current)
                        current = {}
        if "Zone Information" in line:
            in_table = True
            count = 0

    n = len(records)
    records.sort(key=lambda r: r["zaxis"])  # stable sort by floor height
    zones = [Zone(r["name"], r["zaxis"], r["xmin"], r["xmax"], r["ymin"],
                  r["ymax"], r["zmin"], r["zmax"], r["floor_area"],
                  r["exterior_gross_area"], r["exterior_window_area"], i)
             for i, r in enumerate(records)]

    layers: list[list[Zone]] = []
    current_layer: list[Zone] = []
    current_z = zones[0].zaxis
    for zone in zones:
        if zone.zaxis == current_z:
            current_layer.append(zone)
        else:
            layers.append(current_layer)
            current_layer = [zone]
            current_z = zone.zaxis
    layers.append(current_layer)
    return layers, n, zones


# ---------------------------------------------------------------------------
# RC network construction
# ---------------------------------------------------------------------------

def _overlaps_same_layer(z1: Zone, z2: Zone) -> bool:
    a = z2.xmin <= z1.xmin <= z2.xmax and z2.ymin <= z1.ymin <= z2.ymax
    b = z2.xmin <= z1.xmax <= z2.xmax and z2.ymin <= z1.ymax <= z2.ymax
    return a or b


def _overlaps_cross_layer(z1: Zone, z2: Zone) -> bool:
    a = z2.xmin <= z1.xmin < z2.xmax and z2.ymin <= z1.ymin < z2.ymax
    b = z2.xmin < z1.xmax <= z2.xmax and z2.ymin < z1.ymax <= z2.ymax
    return a or b


def build_rc_tables(n: int, layers: Sequence[Sequence[Zone]], u: Ufactor
                    ) -> tuple[dict[str, list[int]], np.ndarray, np.ndarray, np.ndarray]:
    """Builds conductance (R), capacitance (C) and window tables from zone
    geometry, including the reference's y-overlap quirk where
    ``min(Ymax) - max(z1.Ymin, z1.Ymin)`` uses z1 twice (kept for parity
    with the JAX package and the reference; the presumable intent is
    z2.Ymin).
    """
    rtable = np.zeros((n, n + 1))
    ctable = np.zeros(n)
    windowtable = np.zeros(n)
    neighbors: dict[str, list[int]] = {}

    def add_neighbor(name: str, ind: int) -> None:
        neighbors.setdefault(name, []).append(ind)

    outind = n
    num_layers = len(layers)
    for k, layer in enumerate(layers):
        if k + 1 < num_layers:
            for z1 in layer:
                for z2 in layers[k + 1]:
                    if _overlaps_cross_layer(z1, z2) or _overlaps_cross_layer(z2, z1):
                        x_ov = min(z1.xmax, z2.xmax) - max(z1.xmin, z2.xmin)
                        y_ov = min(z1.ymax, z2.ymax) - max(z1.ymin, z1.ymin)  # parity quirk
                        cross_area = x_ov * y_ov
                        # floor and ceiling conductances in series
                        cond = cross_area * (u.floor * u.ceiling / (u.floor + u.ceiling))
                        rtable[z2.ind, z1.ind] = cond
                        rtable[z1.ind, z2.ind] = cond
                        add_neighbor(z1.name, z2.ind)
                        add_neighbor(z2.name, z1.ind)

        for i, z1 in enumerate(layer):
            height = z1.zmax - z1.zmin
            xlen = z1.xmax - z1.xmin
            ylen = z1.ymax - z1.ymin
            ctable[z1.ind] = SPECIFIC_HEAT_AIR * height * xlen * ylen * AIR_DENSITY
            windowtable[z1.ind] = z1.exterior_window_area

            if z1.exterior_gross_area > 0 or (i == len(layer) - 1):
                if i == len(layer) - 1:
                    # top-most zone in layer also loses heat through the roof
                    rtable[z1.ind, -1] = (z1.exterior_gross_area * u.outwall
                                          + xlen * ylen * u.roof
                                          + z1.exterior_window_area * u.window)
                else:
                    rtable[z1.ind, -1] = (z1.exterior_gross_area * u.outwall
                                          + z1.exterior_window_area * u.window)
                add_neighbor(z1.name, outind)

            for j in range(i + 1, len(layer)):
                z2 = layer[j]
                if _overlaps_same_layer(z1, z2) or _overlaps_same_layer(z2, z1):
                    x_ov = min(z1.xmax, z2.xmax) - max(z1.xmin, z2.xmin)
                    y_ov = min(z1.ymax, z2.ymax) - max(z1.ymin, z1.ymin)  # parity quirk
                    shared_len = math.sqrt(x_ov ** 2 + y_ov ** 2)
                    cond = height * shared_len * u.intwall
                    rtable[z2.ind, z1.ind] = cond
                    rtable[z1.ind, z2.ind] = cond
                    add_neighbor(z1.name, z2.ind)
                    add_neighbor(z2.name, z1.ind)

    return neighbors, rtable, ctable, windowtable


def _interp_to_res(values: np.ndarray, time_res: int) -> np.ndarray:
    """Linear interpolation of hourly samples onto a ``time_res``-second
    grid."""
    num = len(values)
    x = np.arange(num)
    xnew = np.arange(0, num - 1, time_res / 3600.0)
    return np.interp(xnew, x, values)


def build_continuous_matrices(
        rtable: np.ndarray, ctable: np.ndarray, windowtable: np.ndarray,
        neighbors: dict[str, list[int]], zones: Sequence[Zone],
        layers: Sequence[Sequence[Zone]], u: Ufactor, n: int,
        full_occ, max_power, ac_map, shgc_scaled: float, ground_weight: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assembles the continuous-time A, B, D matrices of the RC model."""
    rctable = rtable / ctable[:, None]

    connectmap = np.zeros((n, n + 1))
    for i, zone in enumerate(zones):
        connectmap[i, neighbors.get(zone.name, [])] = 1

    ground_connect = np.zeros((n, 1))
    for room in layers[0]:
        ground_connect[room.ind] = room.floor_area * u.groundfloor * ground_weight

    people_full = (np.zeros(n) + full_occ).reshape(n, 1)
    acweight = np.diag(np.zeros(n) + ac_map) * max_power
    weightcmap = np.concatenate(
        (people_full, ground_connect, np.zeros((n, 1)), acweight,
         (windowtable * shgc_scaled).reshape(n, 1)), axis=-1) / ctable[:, None]

    # A: off-diagonal inter-zone conductances; diagonal = -(sum of all
    # conductances incl. ground); occupancy linear term spread over zones.
    ground = weightcmap[:, 1]
    diag = -np.diag(rctable @ connectmap.T) - ground
    A = rctable[:, :-1].copy()
    np.fill_diagonal(A, diag)
    A = A + weightcmap[:, 0] * OCCU_COEF_LINEAR / n

    # B/D: exogenous inputs [occupower | ground | out-temp | AC(n) | solar]
    BD = weightcmap.copy()
    BD[:, 2] = connectmap[:, -1] * rctable[:, -1]
    B = BD[:, 1:]
    D = BD[:, 0]
    return A, B, D


def discretize(A: np.ndarray, B: np.ndarray, D: np.ndarray, time_res: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Exact zero-order-hold discretisation:
    ``A_d = expm(A dt)``, ``BD_d = A^-1 (A_d - I) [D|B]``."""
    from scipy.linalg import expm  # host-side only
    BD = np.hstack((D[:, np.newaxis], B))
    A_d = expm(A * time_res)
    BD_d = np.linalg.inv(A) @ (A_d - np.eye(A.shape[0])) @ BD
    return A_d, BD_d


def generate_building_params(
        building: str,
        weather: str,
        location: str,
        u_wall: Ufactor | Sequence[float] = (0,) * 7,
        ground_temp: Sequence[float] = (0,) * 12,
        shgc: float = 0.252,
        shgc_weight: float = 0.01,
        ground_weight: float = 0.5,
        full_occ: np.ndarray | float = 0,
        max_power: float = 8000,
        ac_map: np.ndarray | int = 1,
        time_res: int = 300,
        reward_beta: float = 0.999,
        reward_pnorm: float = 2,
        target: np.ndarray | float = 22,
        activity_sch: np.ndarray | float = 120,
        temp_range: tuple[float, float] = (-40, 40),
        is_continuous_action: bool = True,
        episode_len: int = 288,
        root: str = "",
        stochastic_summer_percentage: float | None = None,
        block_size: int | None = None,
        stochastic_seed: int | None = None,
) -> dict[str, Any]:
    """Compiles all BuildingEnv parameters into plain numpy arrays.

    ``building`` names a prototype of :data:`BUILDINGS` (its HTM file is
    read from the raw-data root) or an HTM file under ``root`` (then
    ``u_wall`` gives its U-factors); ``weather`` names a climate of
    :data:`WEATHER` or an EPW file under ``root``. The returned dict feeds
    :func:`sustaingym_tpu_torch.envs.building.env.make_params`.
    """
    if episode_len * time_res % (24 * 60 * 60) != 0:
        raise ValueError("Episode must be a multiple of 1 day")

    monthly_ground = GROUND_TEMP.get(location, list(ground_temp))
    all_ground = np.concatenate([
        np.full(days * 24, monthly_ground[m])
        for m, days in enumerate(DAYS_PER_MONTH)])

    if building in BUILDINGS:
        htm_name, u = BUILDINGS[building]
        layers, n, zones = parse_zones(raw_path("building", htm_name))
    else:
        u = Ufactor(*u_wall)
        layers, n, zones = parse_zones(os.path.join(root, building))

    if weather in WEATHER:
        weather_data = read_epw(raw_path("building", WEATHER[weather]))
    else:
        weather_data = read_epw(os.path.join(root, weather))

    oneyear = weather_data["temp_air"]
    oneyearrad = weather_data["ghi"]
    # SHGC/GHI normalization always uses the ORIGINAL weather file's max
    ghi_max_original = float(np.max(oneyearrad))

    if stochastic_summer_percentage is not None:
        # resample ambient features from seasonal block-normal fits
        from .stochastic import generate_stochastic_ambients
        all_data = np.stack((oneyear, oneyearrad, all_ground), axis=1)
        hours_per_episode = int(episode_len * time_res / 3600)
        this_block = block_size if block_size is not None else hours_per_episode
        samples = generate_stochastic_ambients(
            stochastic_summer_percentage, len(all_data), all_data,
            this_block, seed=stochastic_seed)
        oneyear = samples[:, 0]
        oneyearrad = samples[:, 1]
        all_ground = samples[:, 2]

    all_ground_temp = _interp_to_res(all_ground, time_res)
    out_temp = _interp_to_res(oneyear, time_res)
    solar = _interp_to_res(oneyearrad, time_res)

    ghi_max = ghi_max_original
    hours_per_step = time_res / 3600.0
    # SHGC scaling converts GHI from Wh to W then applies window gain weight
    shgc_scaled = shgc * shgc_weight * (ghi_max / hours_per_step)

    neighbors, rtable, ctable, windowtable = build_rc_tables(n, layers, u)
    A, B, D = build_continuous_matrices(
        rtable, ctable, windowtable, neighbors, zones, layers, u, n,
        full_occ, max_power, ac_map, shgc_scaled, ground_weight)

    return {
        "n": n,
        "zones": zones,
        "target": np.zeros(n) + target,
        "out_temp": out_temp,
        "ground_temp": all_ground_temp,
        # normalized GHI in [0, 1]
        "ghi": solar / hours_per_step / (ghi_max / hours_per_step),
        "metabolism": activity_sch * np.ones(len(out_temp)),
        "reward_beta": reward_beta,
        "reward_pnorm": reward_pnorm,
        "ac_map": np.zeros(n) + ac_map,
        "max_power": max_power,
        "temp_range": temp_range,
        "is_continuous_action": is_continuous_action,
        "time_resolution": time_res,
        "A": A,
        "B": B,
        "D": D,
        "episode_len": episode_len,
    }
