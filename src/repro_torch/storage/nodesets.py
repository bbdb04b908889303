"""Heterogeneous storage-node sets (paper §5.3, Fig. 4; §6 Table 5).

The paper draws ten-node sets from the Backblaze drive-stats corpus. The
raw corpus is not redistributable here, so each set below encodes the
published characteristics: capacities 5-20 TB, write bandwidths
100-250 MB/s, read bandwidths 100-400 MB/s, and annual failure rates with
the spread shown in Fig. 4 (sub-1% for *Most Reliable*, ~0.6-2.2% for
*Most Used*, up to ~13% for *Most Unreliable*). Read/write bandwidths are
correlated (Pearson ~0.9, Table 4) while AFR is uncorrelated with both.

Values are deterministic constants, not draws, so every benchmark run is
reproducible bit-for-bit.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.types import StorageNode

TB = 1_000_000.0  # MB per TB (decimal, as drive vendors report)


def _mk(rows: Sequence[tuple[str, float, float, float, float]]) -> list[StorageNode]:
    return [
        StorageNode(
            node_id=i,
            name=name,
            capacity_mb=cap_tb * TB,
            write_bw=w_bw,
            read_bw=r_bw,
            annual_failure_rate=afr,
        )
        for i, (name, cap_tb, w_bw, r_bw, afr) in enumerate(rows)
    ]


# (model, capacity TB, write MB/s, read MB/s, annual failure rate)
_MOST_USED = [
    ("TOSHIBA_MG07ACA14TA", 14.0, 216.0, 260.0, 0.0094),
    ("HGST_HUH721212ALE604", 12.0, 196.0, 243.0, 0.0063),
    ("WDC_WUH721414ALE6L4", 14.0, 212.0, 255.0, 0.0043),
    ("ST16000NM001G", 16.0, 230.0, 270.0, 0.0065),
    ("ST12000NM001G", 12.0, 195.0, 249.0, 0.0088),
    ("HGST_HUH721212ALN604", 12.0, 186.0, 235.0, 0.0180),
    ("ST8000NM0055", 8.0, 176.0, 220.0, 0.0122),
    ("ST8000DM002", 8.0, 164.0, 205.0, 0.0102),
    ("ST14000NM001G", 14.0, 211.0, 262.0, 0.0110),
    ("WDC_WUH721816ALE6L4", 16.0, 237.0, 284.0, 0.0035),
]

_MOST_UNRELIABLE = [
    ("ST12000NM0117", 12.0, 193.0, 240.0, 0.1316),
    ("WDC_WUH722222ALE6L4", 20.0, 245.0, 305.0, 0.1052),
    ("ST10000NM001G", 10.0, 184.0, 233.0, 0.0876),
    ("HGST_HUH728080ALE604", 8.0, 163.0, 208.0, 0.0587),
    ("ST8000DM005", 8.0, 162.0, 201.0, 0.0494),
    ("TOSHIBA_MQ01ABF050", 5.0, 104.0, 131.0, 0.0441),
    ("ST500LM030", 5.0, 100.0, 126.0, 0.0391),
    ("ST6000DX000", 6.0, 141.0, 178.0, 0.0322),
    ("WDC_WD5000LPCX", 5.0, 102.0, 128.0, 0.0305),
    ("TOSHIBA_MD04ABA500V", 5.0, 118.0, 149.0, 0.0286),
]

_MOST_RELIABLE = [
    ("HGST_HUH721212ALE600", 12.0, 198.0, 248.0, 0.0009),
    ("WDC_WUH721816ALE6L0", 16.0, 235.0, 282.0, 0.0011),
    ("ST16000NM002J", 16.0, 228.0, 276.0, 0.0013),
    ("HGST_HMS5C4040ALE640", 4.0, 130.0, 165.0, 0.0014),
    ("ST12000NM0008", 12.0, 194.0, 246.0, 0.0016),
    ("TOSHIBA_MG08ACA16TE", 16.0, 233.0, 281.0, 0.0017),
    ("WDC_WUH721414ALE604", 14.0, 214.0, 259.0, 0.0019),
    ("ST10000NM0086", 10.0, 182.0, 230.0, 0.0020),
    ("HGST_HUH721010ALE600", 10.0, 185.0, 236.0, 0.0022),
    ("ST14000NM0138", 14.0, 209.0, 256.0, 0.0024),
]

# Ten copies of the most-used Backblaze model (TOSHIBA MG07ACA14TA).
_HOMOGENEOUS = [("TOSHIBA_MG07ACA14TA", 14.0, 216.0, 260.0, 0.0094)] * 10

NODE_SETS = {
    "most_used": _MOST_USED,
    "most_unreliable": _MOST_UNRELIABLE,
    "most_reliable": _MOST_RELIABLE,
    "homogeneous": _HOMOGENEOUS,
}


def make_node_set(name: str, capacity_scale: float = 1.0) -> list[StorageNode]:
    """Instantiate one of the paper's four node sets.

    ``capacity_scale`` rescales capacities; the paper standardizes the
    workload at 122 TB against ~120 TB of raw capacity, and scaled-down
    benchmark presets shrink nodes and workload together to keep the same
    saturation regime at CI-friendly sizes.
    """
    try:
        rows = NODE_SETS[name]
    except KeyError:
        raise ValueError(f"unknown node set {name!r}; known: {sorted(NODE_SETS)}")
    nodes = _mk(rows)
    for n in nodes:
        n.capacity_mb *= capacity_scale
    return nodes


def chameleon_nodes(capacity_scale: float = 1.0) -> list[StorageNode]:
    """The ten Chameleon Cloud nodes of §6 Table 5 (capacities in GB);
    bandwidths estimated per drive class (SSD/NVMe vs HDD), AFRs per the
    SSD~HDD equivalence the paper cites [31]."""
    rows = [
        ("TACC_INTEL_SSDSC1BG40-0", 0.370, 450.0, 500.0, 0.0090),
        ("TACC_INTEL_SSDSC1BG40-1", 0.370, 450.0, 500.0, 0.0090),
        ("TACC_Seagate_ST2000NX0273", 2.000, 136.0, 160.0, 0.0110),
        ("TACC_Micron_MTFDDAK480TDS", 0.450, 420.0, 480.0, 0.0080),
        ("NRP_Seagate_ST9250610NS-0", 0.200, 115.0, 125.0, 0.0130),
        ("NRP_Seagate_ST9250610NS-1", 0.200, 115.0, 125.0, 0.0130),
        ("UC_Dell_ExpressFlash_CD5", 0.960, 1000.0, 1500.0, 0.0060),
        ("UC_INTEL_SSDPF2KX076TZ-0", 7.600, 1800.0, 2400.0, 0.0050),
        ("UC_Dell_MZ7KM240HMHQ0D3", 0.240, 320.0, 380.0, 0.0100),
        ("UC_INTEL_SSDPF2KX076TZ-1", 0.865, 1800.0, 2400.0, 0.0050),
    ]
    nodes = _mk(rows)
    for n in nodes:
        n.capacity_mb *= capacity_scale
    return nodes
