"""A synthetic building and weather year in the formats BuildingEnv reads.

The raw EnergyPlus tables of the JAX package's buildings are not in the
repository. :func:`write_building_tables` writes a 6-zone office and a
seeded hourly year in Tucson's range, which both packages compile with
``generate_building_params(htm, epw, "Tucson", u_wall=BUILDINGS[
"OfficeSmall"][1], root=dirpath)``: the building of the port's tests,
``chip_smoke.py`` and ``sustaingym_tpu_torch/bench.py``. Imports numpy
only, so a tool can load this file by path.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["BUILDING_ZONES", "write_building_tables"]

# The synthetic building: one storey of an office, a 27.69 m x 18.46 m
# footprint 3.05 m high, cut into a core (x 3.73-23.96, y 3.73-14.73) and
# four perimeter zones 3.73 m deep (south and north span the whole x
# range, east and west the whole y range, as EnergyPlus reports a
# trapezoidal zone's bounding box), under an attic over the whole
# footprint (z 3.05-4.88). Per zone: (name, z origin, x min, x max, y min,
# y max, z min, z max, floor area m^2, exterior gross wall or roof area
# m^2, window area m^2).
BUILDING_ZONES = (
    ("CORE_ZN", 0.0, 3.73, 23.96, 3.73, 14.73, 0.0, 3.05, 222.53, 0.0, 0.0),
    ("PERIMETER_ZN_1", 0.0, 0.0, 27.69, 0.0, 3.73, 0.0, 3.05, 89.37, 84.45,
     20.64),
    ("PERIMETER_ZN_2", 0.0, 23.96, 27.69, 0.0, 18.46, 0.0, 3.05, 54.86,
     56.30, 11.61),
    ("PERIMETER_ZN_3", 0.0, 0.0, 27.69, 14.73, 18.46, 0.0, 3.05, 89.37,
     84.45, 16.51),
    ("PERIMETER_ZN_4", 0.0, 0.0, 3.73, 0.0, 18.46, 0.0, 3.05, 54.86, 56.30,
     11.61),
    ("ATTIC", 3.05, 0.0, 27.69, 0.0, 18.46, 3.05, 4.88, 511.16, 568.12, 0.0),
)


def write_building_tables(dirpath: str, seed: int = 0) -> tuple[str, str]:
    """Writes the building's zone table and a year of hourly weather into
    ``dirpath``, in the formats BuildingEnv reads, and returns their file
    names (htm, epw):

    - ``office_small.table.htm``: an EnergyPlus tabular HTM "Zone
      Information" table of ``BUILDING_ZONES`` (6 zones: the storey's five
      and the attic), each value a ``<td>`` line at its field's offset of
      the table's 32-line zone record;
    - ``tucson_synthetic.epw``: 8 header rows and 8760 hourly records of a
      year in Tucson's range, drawn from ``seed``: dry bulb (field 6) with
      a seasonal cycle (monthly means 11-31 C), a daily one (amplitude
      6-9 C, peak at 15:00) and noise; global horizontal irradiance
      (field 13) from the sun's elevation at 32.1 N, scaled by drawn cloud
      cover and zero at night.
    """
    # line offsets after the table's heading line of each field of zone 0;
    # zone k's are 32 k lines further
    offsets = (35, 42, 46, 47, 48, 49, 50, 51, 56, 58, 59)
    cell = '    <td align="right">'          # 22 characters before a value
    values = {}
    for k, zone in enumerate(BUILDING_ZONES):
        for off, value in zip(offsets, zone):
            text = value if isinstance(value, str) else f"{value:.2f}"
            values[off + 32 * k] = f"{cell}{text}</td>\n"
    lines = ["<html><body>\n", "<b>Zone Information</b><br><br>\n"]
    lines += [values.get(rel, "    <td>&nbsp;</td>\n")
              for rel in range(1, max(values) + 1)]
    lines += ["<b>Zone Internal Gains Nominal</b>\n", "</body></html>\n"]
    htm = "office_small.table.htm"
    with open(os.path.join(dirpath, htm), "w") as f:
        f.writelines(lines)

    rng = np.random.default_rng(seed)
    hours = np.arange(8760)
    doy, hod = hours // 24, hours % 24
    season = -np.cos(2 * np.pi * (doy - 15) / 365.0)      # -1 mid-January
    daily = np.cos(2 * np.pi * (hod - 15) / 24.0)         # +1 at 15:00
    temp = (21.0 + 10.0 * season + (7.5 + 1.5 * season) * daily
            + rng.normal(0.0, 1.2, 8760))
    decl = np.radians(23.44) * np.sin(2 * np.pi * (284 + doy) / 365.0)
    lat, omega = np.radians(32.1), np.radians(15.0 * (hod + 0.5 - 12.0))
    sin_elev = (np.sin(lat) * np.sin(decl)
                + np.cos(lat) * np.cos(decl) * np.cos(omega))
    clouds = rng.uniform(0.55, 1.0, 366)[doy]
    ghi = np.rint(1050.0 * np.clip(sin_elev, 0.0, None) ** 1.15 * clouds)
    header = ["LOCATION,Tucson Synthetic,AZ,USA,TMY3,722745,32.13,-110.95,"
              "-7.0,779.0\n",
              "DESIGN CONDITIONS,0\n", "TYPICAL/EXTREME PERIODS,0\n",
              "GROUND TEMPERATURES,0\n",
              "HOLIDAYS/DAYLIGHT SAVINGS,No,0,0,0\n",
              f"COMMENTS 1,synthetic year drawn from seed {seed}\n",
              "COMMENTS 2,\n", "DATA PERIODS,1,1,Data,Sunday, 1/ 1,12/31\n"]
    month_starts = np.cumsum([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30])
    records = []
    for h in range(8760):
        month = int(np.searchsorted(month_starts, doy[h], side="right"))
        day = int(doy[h] - month_starts[month - 1]) + 1
        records.append(
            f"1990,{month},{day},{hod[h] + 1},60,?9?9?9?9E0?9?9?9?9?9?9?9?9?9"
            f"?9?9?9?9?9*9*9,{temp[h]:.1f},{temp[h] - 15.0:.1f},25,92500,0,"
            f"0,300,{int(ghi[h])},{int(0.8 * ghi[h])},{int(0.2 * ghi[h])},0,"
            f"0,0,0,0,0,0,0,0,0,0,0,0,0.1,0,0,0,0,0\n")
    epw = "tucson_synthetic.epw"
    with open(os.path.join(dirpath, epw), "w") as f:
        f.writelines(header + records)
    return htm, epw
