"""The program under test for exact dense search: a ``DeviceSpace`` over
the rows as the port's format constants lay them out, with their squared
norms, behind a ``SearchEngine``, all through the port's public API."""

import torch

CHUNK = 1 << 17


def _dtype(cfg):
    from metrovector_tpu_torch.format.constants import DataType

    return DataType[cfg["dtype"].upper()]


def layout(cfg) -> tuple[int, int]:
    """Rows and dims of the block the port keeps for the configuration."""
    from metrovector_tpu_torch.format.constants import padded_dim_for, padded_rows_for

    return (padded_rows_for(int(cfg["rows"]), _dtype(cfg)),
            padded_dim_for(int(cfg["dim"]), True))


def build(cfg, rows: torch.Tensor, device):
    """A ``SearchEngine`` over ``rows`` (laid out by :func:`layout`); the
    norms are those of the dequantized rows, in f32."""
    from metrovector_tpu_torch.engine import DeviceSpace, SearchEngine
    from metrovector_tpu_torch.format.constants import DistanceMetric

    n, d = int(cfg["rows"]), int(cfg["dim"])
    scale = float(cfg.get("scale", 1.0))
    norms = torch.zeros(rows.shape[0], dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK):
        v = rows[s:min(n, s + CHUNK), :d].float() * scale
        norms[s:s + v.shape[0]] = (v * v).sum(1)
    space = DeviceSpace(data=rows, norms=norms, num_valid=n, dim=d,
                        metric=DistanceMetric[cfg["metric"]], dtype=_dtype(cfg),
                        name=cfg["name"], precision=cfg["precision"], scale=scale)
    return SearchEngine(space, precision=cfg["precision"])


def library_ready() -> bool:
    """Whether the port's kernels' library is already built for its
    sources, so that this run only loads it."""
    from metrovector_tpu_torch.ops import _build

    return (_build.build_dir() / _build.LIB_NAME).is_file()
