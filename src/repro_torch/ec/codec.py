"""Item-level erasure codec: bytes -> N chunks -> bytes (with erasures).

Wraps the chunk-matrix kernels with the split/pad/join bookkeeping the
checkpoint manager needs.  A ``ECCodec(k, p)`` is the data-plane
counterpart of a :class:`repro_torch.core.types.Placement`.  Payloads
may be bytes, numpy arrays or uint8 tensors; chunks and decoded payloads
are uint8 tensors on the codec's ``device`` (default ``cuda``).

Batch API: :meth:`ECCodec.encode_many` / :meth:`ECCodec.decode_many`
drive whole cohorts of payloads through one kernel launch per coding
matrix (see ``repro_torch.kernels.ops``), and the module-level planner
(:func:`plan_cohorts` / :func:`encode_batch`) partitions a mixed list of
``(k, p)`` codings into those cohorts.  The per-item
:meth:`ECCodec.encode` / :meth:`ECCodec.decode` path is the oracle the
batched paths are pinned against.  Byte-identical to the JAX package's
``repro.ec.codec``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch._device import resolve_device
from repro_torch.kernels import ops as kops

__all__ = [
    "ECCodec",
    "encode_item",
    "decode_item",
    "plan_cohorts",
    "encode_batch",
]


def _as_bytes_tensor(payload, device: torch.device) -> torch.Tensor:
    """Flat uint8 tensor on ``device`` for one payload."""
    if isinstance(payload, torch.Tensor):
        if payload.dtype != torch.uint8:
            raise TypeError(f"payload tensor must be uint8, got {payload.dtype}")
        return payload.reshape(-1).to(device)
    if isinstance(payload, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(payload), dtype=np.uint8).copy()
    else:
        arr = np.array(payload, dtype=np.uint8).ravel()
    return torch.from_numpy(arr).to(device)


@dataclasses.dataclass(frozen=True)
class ECCodec:
    k: int
    p: int
    use_kernel: bool = True
    device: str | torch.device = "cuda"

    @property
    def n(self) -> int:
        return self.k + self.p

    def chunk_len(self, nbytes: int) -> int:
        return -(-nbytes // self.k)  # ceil(size / K), paper Table 1

    def _device(self) -> torch.device:
        return resolve_device(self.device)

    def _data_matrix(self, payload) -> torch.Tensor:
        """(K, chunk_len) zero-padded data rows for one payload."""
        buf = _as_bytes_tensor(payload, self._device())
        clen = self.chunk_len(buf.numel())
        if buf.numel() == self.k * clen:
            return buf.reshape(self.k, clen)
        padded = buf.new_zeros(self.k * clen)
        padded[: buf.numel()] = buf
        return padded.reshape(self.k, clen)

    def encode(self, payload) -> torch.Tensor:
        """payload -> (N, chunk_len) uint8: K data rows then P parity rows.

        An empty payload yields a well-defined empty manifest — shape
        (N, 0), no kernel call."""
        data = self._data_matrix(payload)
        if data.shape[1] == 0:
            return data.new_zeros((self.n, 0))
        parity = kops.encode_chunks(data, self.p, use_kernel=self.use_kernel)
        return torch.cat([data, parity], dim=0)

    def encode_many(self, payloads: Sequence) -> list[torch.Tensor]:
        """Encode a cohort of payloads in ONE kernel launch.

        Payload lengths may differ (the code is columnwise; the kernel
        sees the cohort concatenated along the byte axis).  Returns the
        (N, chunk_len_i) chunk matrices in input order, byte-identical to
        per-item :meth:`encode`."""
        datas = [self._data_matrix(p) for p in payloads]
        parities = kops.encode_chunks_many(
            datas, self.p, use_kernel=self.use_kernel
        )
        return [torch.cat([d, par], dim=0) for d, par in zip(datas, parities)]

    def _select_rows(self, chunks, rows) -> tuple[torch.Tensor, np.ndarray]:
        """Deterministic choice of K rows (sorted; systematic first), on
        the codec's device.  A tensor of exactly K rows in ascending order
        is that choice already and is passed through as it is."""
        rows = np.asarray(rows)
        n_rows = chunks.shape[0]
        if n_rows < self.k:
            raise ValueError(f"need at least K={self.k} chunks, got {n_rows}")
        tensor = isinstance(chunks, torch.Tensor)
        if tensor and n_rows == self.k and bool(np.all(np.diff(rows) > 0)):
            return chunks.to(self._device()), rows
        sel = np.argsort(rows)[: self.k]
        if tensor:
            picked = chunks[torch.from_numpy(sel).to(chunks.device)]
        else:
            picked = torch.from_numpy(np.array(chunks, dtype=np.uint8)[sel])
        return picked.to(self._device()), rows[sel]

    def decode(self, chunks, rows, orig_nbytes: int) -> torch.Tensor:
        """Any K chunk rows (+ their row indices) -> the original payload
        as a flat uint8 tensor."""
        use_chunks, use_rows = self._select_rows(chunks, rows)
        if orig_nbytes == 0 or use_chunks.shape[1] == 0:
            return use_chunks.new_zeros(0)
        if np.array_equal(use_rows, np.arange(self.k)):
            data = use_chunks  # all-systematic fast path: no math
        else:
            data = kops.decode_chunks(
                use_chunks, use_rows, self.k, self.p,
                use_kernel=self.use_kernel,
            )
        return data.reshape(-1)[:orig_nbytes]

    def decode_many(self, parts: Sequence[tuple]) -> list[torch.Tensor]:
        """Decode a cohort of ``(chunks, rows, orig_nbytes)`` triples.

        All-systematic items take the no-math fast path; the rest run
        one kernel launch per distinct erasure pattern.  Byte-identical
        to per-item :meth:`decode`."""
        outs: list = [None] * len(parts)
        pend_idx: list[int] = []
        pend_chunks: list[torch.Tensor] = []
        pend_rows: list[np.ndarray] = []
        systematic = np.arange(self.k)
        for i, (chunks, rows, orig_nbytes) in enumerate(parts):
            use_chunks, use_rows = self._select_rows(chunks, rows)
            if orig_nbytes == 0 or use_chunks.shape[1] == 0:
                outs[i] = use_chunks.new_zeros(0)
            elif np.array_equal(use_rows, systematic):
                outs[i] = use_chunks.reshape(-1)[:orig_nbytes]
            else:
                pend_idx.append(i)
                pend_chunks.append(use_chunks)
                pend_rows.append(use_rows)
        if pend_idx:
            with telemetry.span("ec.decode_kernel"):
                datas = kops.decode_chunks_many(
                    pend_chunks, pend_rows, self.k, self.p,
                    use_kernel=self.use_kernel,
                )
            for i, data in zip(pend_idx, datas):
                outs[i] = data.reshape(-1)[: parts[i][2]]
        return outs


def plan_cohorts(specs: Sequence[tuple[int, int]]) -> list[tuple[tuple[int, int], list[int]]]:
    """Partition payload indices by codec shape.

    ``specs[i] = (k, p)`` for payload i; returns ``[((k, p), indices),
    ...]`` in first-appearance order — each cohort shares one coding
    matrix and therefore one kernel launch."""
    order: dict[tuple[int, int], list[int]] = {}
    for i, (k, p) in enumerate(specs):
        order.setdefault((int(k), int(p)), []).append(i)
    return list(order.items())


def encode_batch(
    specs: Sequence[tuple[int, int]],
    payloads: Sequence,
    *,
    use_kernel: bool = True,
    device: str | torch.device = "cuda",
) -> list[torch.Tensor]:
    """Encode a mixed-(K, P) batch: one launch per (K, P) cohort.

    Returns the (N_i, chunk_len_i) chunk matrices in input order."""
    if len(specs) != len(payloads):
        raise ValueError("specs/payloads length mismatch")
    outs: list = [None] * len(payloads)
    for (k, p), idxs in plan_cohorts(specs):
        codec = ECCodec(k, p, use_kernel=use_kernel, device=device)
        for i, chunks in zip(idxs, codec.encode_many([payloads[i] for i in idxs])):
            outs[i] = chunks
    return outs


def encode_item(
    payload, k: int, p: int, use_kernel: bool = True, device="cuda"
) -> torch.Tensor:
    return ECCodec(k, p, use_kernel, device).encode(payload)


def decode_item(
    chunks,
    rows,
    k: int,
    p: int,
    orig_nbytes: int,
    use_kernel: bool = True,
    device="cuda",
) -> torch.Tensor:
    return ECCodec(k, p, use_kernel, device).decode(chunks, rows, orig_nbytes)
