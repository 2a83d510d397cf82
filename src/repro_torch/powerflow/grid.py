"""Synthetic transmission-grid generator: the port's own copy of
``repro.powerflow.grid`` (numpy only; the same seed gives the same arrays,
bit for bit).

The paper's German grid data (2715 buses, 5351 lines, 871 generators,
18 HVDC lines — 2012 NEP topology) is confidential; the generator makes a
synthetic grid with the same counts and realistic per-unit parameters.
Geometry: buses sampled in a 2D plane, connected by a spanning tree plus
k-nearest-neighbor edges to the published line/bus ratio (~1.97), giving a
meshed topology whose powerflow is well-conditioned.

All arrays are numpy on the host; ``Grid.to_torch(device)`` produces the
device-side dict (dense complex64 Ybus etc.), and :func:`grid_from_numpy`
carries a grid's fields over from the reference as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


GERMAN_GRID_SPEC = dict(n_bus=2715, n_line=5351, n_gen=871, n_hvdc=18,
                        hvdc_pmax_mw=(1300.0,) * 9 + (2000.0,) * 9)

BASE_MVA = 100.0


@dataclasses.dataclass
class Grid:
    # buses
    n_bus: int
    bus_type: np.ndarray          # (n,) 0=PQ, 1=PV, 2=slack
    p_load: np.ndarray            # (n,) p.u.
    q_load: np.ndarray            # (n,) p.u.
    p_gen: np.ndarray             # (n,) p.u. scheduled
    v_set: np.ndarray             # (n,) voltage setpoints
    # lines
    f_bus: np.ndarray             # (L,) int
    t_bus: np.ndarray             # (L,) int
    r: np.ndarray                 # (L,) p.u.
    x: np.ndarray                 # (L,) p.u.
    b_sh: np.ndarray              # (L,) total line charging
    rate: np.ndarray              # (L,) thermal limit p.u.
    # hvdc
    hvdc_f: np.ndarray            # (H,) int
    hvdc_t: np.ndarray            # (H,) int
    hvdc_pmax: np.ndarray         # (H,) p.u.

    @property
    def n_line(self) -> int:
        return len(self.f_bus)

    @property
    def n_hvdc(self) -> int:
        return len(self.hvdc_f)

    def ybus(self) -> np.ndarray:
        """Dense complex bus admittance matrix."""
        n = self.n_bus
        ys = 1.0 / (self.r + 1j * self.x)
        bc = 1j * self.b_sh / 2.0
        y = np.zeros((n, n), np.complex128)
        f, t = self.f_bus, self.t_bus
        np.add.at(y, (f, f), ys + bc)
        np.add.at(y, (t, t), ys + bc)
        np.add.at(y, (f, t), -ys)
        np.add.at(y, (t, f), -ys)
        # small shunt for numerical conditioning
        y[np.diag_indices(n)] += 1e-6j
        return y

    def to_torch(self, device, dtype=torch.complex64) -> dict:
        """The device-side dict of ``repro``'s ``Grid.to_jax()``: the same
        keys, dtypes and values (complex Ybus and series admittances in
        ``dtype``, float32 quantities, int32 indices), on ``device``."""
        rdtype = torch.float32

        def t(x, dt=None):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

        def idx(x):
            return t(np.asarray(x).astype(np.int32))
        return {
            "ybus": t(self.ybus(), dtype),
            "bus_type": idx(self.bus_type),
            "p_inj": t((self.p_gen - self.p_load).astype(np.float32), rdtype),
            "q_inj": t((-self.q_load).astype(np.float32), rdtype),
            "v_set": t(self.v_set.astype(np.float32), rdtype),
            "f_bus": idx(self.f_bus), "t_bus": idx(self.t_bus),
            "y_series": t(1.0 / (self.r + 1j * self.x), dtype),
            "b_sh": t(self.b_sh.astype(np.float32), rdtype),
            "rate": t(self.rate.astype(np.float32), rdtype),
            "hvdc_f": idx(self.hvdc_f), "hvdc_t": idx(self.hvdc_t),
            "hvdc_pmax": t(self.hvdc_pmax.astype(np.float32), rdtype),
        }


def make_synthetic_grid(n_bus: int = 2715, n_line: int = 5351,
                        n_gen: int = 871, n_hvdc: int = 18,
                        hvdc_pmax_mw=None, seed: int = 0,
                        total_load_pu: float | None = None) -> Grid:
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, size=(n_bus, 2))

    # spanning tree (randomized Prim over random geometric graph) + kNN fill
    edges = set()
    order = rng.permutation(n_bus)
    in_tree = [order[0]]
    intree_pts = pts[order[0]][None]
    for v in order[1:]:
        d = np.sum((intree_pts - pts[v]) ** 2, axis=1)
        u = in_tree[int(np.argmin(d))]
        edges.add((min(u, v), max(u, v)))
        in_tree.append(v)
        intree_pts = np.vstack([intree_pts, pts[v]])

    # add nearest-neighbor edges until n_line
    k = 8
    # chunked kNN to avoid n^2 memory blowup for big n
    cand = []
    chunk = 512
    for s in range(0, n_bus, chunk):
        block = pts[s:s + chunk]
        d = np.sum((block[:, None] - pts[None]) ** 2, axis=2)
        np.put_along_axis(d, np.arange(s, min(s + chunk, n_bus))[:, None] - 0,
                          np.inf, axis=1)
        nn = np.argsort(d, axis=1)[:, :k]
        for i, row in enumerate(nn):
            for j in row:
                cand.append((min(s + i, int(j)), max(s + i, int(j))))
    rng.shuffle(cand)
    for e in cand:
        if len(edges) >= n_line:
            break
        if e[0] != e[1]:
            edges.add(e)
    edges = sorted(edges)[:n_line]
    while len(edges) < n_line:                 # top up with random long lines
        a, b = rng.integers(0, n_bus, 2)
        if a != b:
            e = (min(a, b), max(a, b))
            if e not in edges:
                edges.append(e)
    f_bus = np.array([e[0] for e in edges])
    t_bus = np.array([e[1] for e in edges])
    nl = len(edges)

    # impedances: 380kV-class lines, length ~ distance
    length = np.linalg.norm(pts[f_bus] - pts[t_bus], axis=1) + 0.02
    x = 0.25 * length * rng.uniform(0.8, 1.2, nl)
    r = x * rng.uniform(0.08, 0.15, nl)
    b_sh = 0.4 * length * rng.uniform(0.8, 1.2, nl)

    # generators on random buses; slack = bus with largest capacity
    gen_buses = rng.choice(n_bus, size=n_gen, replace=False)
    cap = rng.lognormal(mean=0.0, sigma=0.8, size=n_gen)

    # loads everywhere; ~0.3 p.u./bus average => ~80 GW at German size
    if total_load_pu is None:
        total_load_pu = 0.295 * n_bus
    p_load = rng.lognormal(0.0, 0.6, n_bus)
    p_load = p_load / p_load.sum() * total_load_pu
    q_load = p_load * rng.uniform(0.2, 0.4, n_bus)

    # dispatch gens to cover load + ~2% losses
    p_gen_unit = cap / cap.sum() * p_load.sum() * 1.02
    p_gen = np.zeros(n_bus)
    np.add.at(p_gen, gen_buses, p_gen_unit)

    bus_type = np.zeros(n_bus, np.int32)
    bus_type[gen_buses] = 1                                  # PV
    slack = gen_buses[int(np.argmax(cap))]
    bus_type[slack] = 2                                      # slack
    v_set = np.ones(n_bus)
    v_set[gen_buses] = rng.uniform(1.0, 1.03, n_gen)

    # thermal ratings: ~2.2x base-case heuristic flow capacity
    rate = np.maximum(2.0, 6.0 * length) * rng.uniform(0.9, 1.3, nl)

    # HVDC endpoints: long-distance pairs (paper: north-south corridors)
    hf, ht = [], []
    tries = 0
    while len(hf) < n_hvdc and tries < 10_000:
        a, b = rng.integers(0, n_bus, 2)
        if a != b and np.linalg.norm(pts[a] - pts[b]) > 0.5:
            hf.append(a)
            ht.append(b)
        tries += 1
    pmax = (np.asarray(hvdc_pmax_mw) / BASE_MVA if hvdc_pmax_mw is not None
            else np.full(n_hvdc, 13.0))

    return Grid(n_bus=n_bus, bus_type=bus_type,
                p_load=p_load,                       # already p.u. (100 MVA)
                q_load=q_load,
                p_gen=p_gen,
                v_set=v_set,
                f_bus=f_bus, t_bus=t_bus, r=r, x=x, b_sh=b_sh, rate=rate,
                hvdc_f=np.asarray(hf), hvdc_t=np.asarray(ht),
                hvdc_pmax=np.asarray(pmax, np.float64))


def make_german_grid(seed: int = 0) -> Grid:
    return make_synthetic_grid(seed=seed, **{k: v for k, v in
                                             GERMAN_GRID_SPEC.items()
                                             if k != "hvdc_pmax_mw"},
                               hvdc_pmax_mw=GERMAN_GRID_SPEC["hvdc_pmax_mw"])


def grid_from_numpy(fields: dict) -> Grid:
    """The port's ``Grid`` from a grid's fields as numpy arrays (for
    example ``dataclasses.asdict`` of the reference's ``Grid``)."""
    names = [f.name for f in dataclasses.fields(Grid)]
    missing = sorted(set(names) - set(fields))
    if missing:
        raise ValueError(f"grid fields missing: {missing}")
    return Grid(**{k: (int(fields[k]) if k == "n_bus"
                       else np.array(fields[k], copy=True)) for k in names})
