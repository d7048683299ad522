"""Combined-cycle plant surrogate, 18 inputs -> 29 outputs, in PyTorch.

The port of ``sustaingym_tpu.envs.cogen.plant``: a physics-informed
surrogate of a 3 x (gas turbine + HRSG) + steam-turbine cogeneration plant
with the reference's 18 -> 29 signature (its ONNX network is absent).
``plant_model`` maps (..., 18) inputs to (..., 29) outputs over any leading
batch dims.

Every operation is a float32 elementwise op in the JAX module's order, and
every sum over gas turbines or cost groups is written as left-to-right
additions, so the CUDA kernel ``ops/cuda/csrc/cogen_rollout.cu`` (built
without FMA contraction) can repeat this arithmetic exactly. Constants are
NumPy float64, rounded to float32 once where they meet a tensor (a Python
scalar operand or clip bound is rounded to the tensor's float32, as JAX
rounds its weakly typed scalars).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.graph import device_const, device_index

__all__ = ["plant_model", "sum_last", "GT_PWR_LO", "GT_PWR_HI", "HR_LO", "HR_HI",
           "ST_LO", "ST_HI", "IP_LO", "IP_HI"]

# ---- input indices (model.json "inputs") ---------------------------------
TAMB, PAMB, RHAMB = 0, 1, 2
GT_PAC = (3, 6, 9)
GT_EVC = (4, 7, 10)
GT_PWR = (5, 8, 11)
HR_PROC = (12, 13, 14)
ST_PWR, IPPROC_M, CT_NRBAYS = 15, 16, 17

# ---- input bounds (model.json) -------------------------------------------
GT_PWR_LO = np.array([41.640958739408575, 41.4901380260007, 46.46162639456023])
GT_PWR_HI = np.array([168.26699084133313, 168.41364372684487, 172.43912889854244])
HR_LO = np.array([403.158098976746, 396.6747280218317, 438.9994717062812])
HR_HI = np.array([819.5712701252007, 817.3514297249753, 870.265011732758])
ST_LO, ST_HI = 25.653593808895327, 83.53805140752395
IP_LO, IP_HI = -1218.227252306133, -318.0558547331499

# ---- output bounds used for clipping envelopes (model.json "outputs") ----
GT_FUEL_MAX = np.array([76.69372527575013, 76.5767979002884, 74.85078517549726])
DB_FUEL_MAX = 18.302679412053344
PWR_MIN_BOUNDS = (np.array([51.226136, 51.154142, 53.382063]),
                  np.array([159.372284, 159.385700, 163.718997]))
PWR_MAX_BOUNDS = (np.array([104.556475, 104.663273, 106.848688]),
                  np.array([168.765869, 168.816834, 172.422358]))
STEAM_MIN_BOUNDS = (np.array([297.682785, 297.101498, 328.001105]),
                    np.array([496.926494, 494.038342, 533.750224]))
STEAM_MAX_BOUNDS = (np.array([548.318195, 550.350075, 594.735073]),
                    np.array([849.448828, 850.610284, 894.579579]))
ST_MAX_CLIP = 193.2981069908212
ST_MIN_CLIP = (25.603735384829225, 251.5737866469593)
IPLD_MIN_CLIP = (-1901.360063349245, -317.85686602279907)
IPLD_MAX_CLIP = (-469.4936696089783, -317.82291691135345)
AUX_CLIP = (1.2668176093005532, 22.42884599132708)

T_ISO = 59.0  # deg F


def sum_last(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, added left to right (the kernel's order)."""
    out = v[..., 0]
    for i in range(1, v.shape[-1]):
        out = out + v[..., i]
    return out


def plant_model(x: torch.Tensor) -> torch.Tensor:
    """Evaluates the plant surrogate on (..., 18) float32 inputs in
    model.json order; returns (..., 29) float32 outputs in model.json
    order."""
    def const(a):
        return device_const(a, x.device)

    def cols(idx):
        return x[..., device_index(idx, x.device)]

    tamb, pamb, rh = x[..., TAMB:TAMB + 1], x[..., PAMB:PAMB + 1], \
        x[..., RHAMB:RHAMB + 1]
    pac = cols(GT_PAC)
    evc = cols(GT_EVC)
    pwr = cols(GT_PWR)
    hr_steam = cols(HR_PROC)
    st_pwr, ipproc, nbays = x[..., ST_PWR], x[..., IPPROC_M], x[..., CT_NRBAYS]
    gt_pwr_hi, hr_lo, hr_hi = const(GT_PWR_HI), const(HR_LO), const(HR_HI)

    # compressor-inlet temperature after optional evaporative cooling
    depression = 0.35 * torch.clamp(tamb - 32.0, min=0.0) * (1.0 - rh)
    teff = tamb - 0.85 * evc * depression                       # (..., 3)
    hot = torch.clamp(teff - T_ISO, min=0.0)
    cold = torch.clamp(T_ISO - teff, min=0.0)
    # true division by a device tensor: CUDA divides a tensor by a Python
    # scalar as a multiplication by its reciprocal
    pressure_gain = torch.pow(pamb / const(14.6), 0.3)

    # --- operating envelopes -------------------------------------------
    pwr_max = gt_pwr_hi * (1.0 - 0.0042 * hot + 0.0006 * cold) \
        * (1.0 + 0.035 * pac) * pressure_gain
    pwr_max = torch.clamp(pwr_max, const(PWR_MAX_BOUNDS[0]),
                          const(PWR_MAX_BOUNDS[1]))
    tnorm = torch.clamp((teff - 32.0) / const(83.0), 0.0, 1.0)
    pwr_min_lo, pwr_min_hi = const(PWR_MIN_BOUNDS[0]), const(PWR_MIN_BOUNDS[1])
    pwr_min = pwr_min_lo + (pwr_min_hi - pwr_min_lo) * 0.45 \
        * torch.pow(tnorm, 1.5)

    # --- gas-turbine fuel ----------------------------------------------
    load = pwr / gt_pwr_hi
    amb_fuel = 1.0 + 0.0015 * hot - 0.0004 * cold
    gt_fuel_max = const(GT_FUEL_MAX)
    gt_fuel = gt_fuel_max * amb_fuel * (1.0 + 0.02 * pac) \
        * (0.08 + 0.82 * load + 0.10 * (load * load))
    gt_fuel = torch.clamp(gt_fuel, min=0.0).minimum(gt_fuel_max)

    # --- HRSG steam capability and duct burners -------------------------
    unfired = hr_lo * 1.02 + (hr_hi * 0.82 - hr_lo) * load
    db_steam = torch.clamp(hr_steam - unfired, min=0.0)
    db_span = hr_hi - unfired + 1e-6
    db_fuel = torch.clamp(DB_FUEL_MAX * db_steam / db_span, 0.0, DB_FUEL_MAX)
    steam_min = torch.clamp(0.72 * unfired, const(STEAM_MIN_BOUNDS[0]),
                            const(STEAM_MIN_BOUNDS[1]))
    steam_max = torch.clamp(unfired + 0.22 * hr_hi,
                            const(STEAM_MAX_BOUNDS[0]),
                            const(STEAM_MAX_BOUNDS[1]))

    # --- steam-turbine and IP letdown envelopes --------------------------
    hr_total = sum_last(hr_steam)
    st_max = torch.clamp(0.09 * hr_total + 0.05 * (-ipproc) - 40.0
                         + 1.5 * (nbays - 6.0), 0.0, ST_MAX_CLIP)
    st_min = torch.clamp(0.03 * hr_total - 20.0, *ST_MIN_CLIP)
    ip_ldwn_min = torch.clamp(-0.17 * hr_total + 12.0, *IPLD_MIN_CLIP)
    ip_ldwn_max = torch.clamp(-0.18 * hr_total, *IPLD_MAX_CLIP)

    # --- balances --------------------------------------------------------
    gt_hr_fuel = gt_fuel + db_fuel
    plant_fuel = sum_last(gt_hr_fuel)
    pwr_sum = sum_last(pwr)
    aux = torch.clamp(2.0 + 0.02 * (pwr_sum + st_pwr) + 0.35 * nbays
                      + 0.5 * sum_last(pac), *AUX_CLIP)
    net_pwr = pwr_sum + st_pwr - aux
    proc_steam = hr_total + ipproc

    def interleave(lo, hi):
        return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1],
                            lo[..., 2], hi[..., 2]], -1)

    return torch.cat([
        gt_fuel,                                   # 0-2   GTi_NG_M
        db_fuel,                                   # 3-5   HRi_DBNG_M
        gt_hr_fuel,                                # 6-8   GTi_HRi_NG_M
        interleave(pwr_min, pwr_max),              # 9-14  gti pwr min/max
        interleave(steam_min, steam_max),          # 15-20 hri steam min/max
        torch.stack([plant_fuel,                   # 21    PLANT_NG_M
                     ip_ldwn_min, ip_ldwn_max,     # 22-23
                     st_min, st_max,               # 24-25
                     aux, net_pwr, proc_steam], -1),  # 26-28
    ], -1)

