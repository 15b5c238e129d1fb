"""Checkpoint ingestion: safetensors files and external quantized tensors →
the port's records.

The counterpart of ``bitorch_engine_tpu/utils/ingest.py``:

* **safetensors** (:func:`load_safetensors`, :func:`save_safetensors`): the
  format read and written here without the ``safetensors`` package: a
  little-endian u64 header length, a JSON header (``dtype``, ``shape``,
  ``data_offsets`` per tensor, an optional ``__metadata__`` of strings),
  then the raw little-endian bytes.  The reader maps the file and makes
  each tensor a view of the mapping, so a file is read once, when its
  tensors are first touched (moved to the card, say).
* **GPTQ** per-layer tensors ``qweight`` int32 ``(K/32*b, N)``, ``qzeros``
  int32 ``(G, N/32*b)``, ``scales`` fp ``(G, N)``, optional ``g_idx``
  (:func:`mpq_from_gptq`; an act-order ``g_idx`` with equal group
  populations is canonicalized into ``q_perm``).
* **GBA double-quantized** tensors (:func:`mpq_from_gba`).
* **exl2 mixed-bit** tensors ``q_weight``, ``q_scale``, ``q_scale_max``,
  ``q_groups``, ``q_invperm`` (:func:`mbwq_from_exl2`), odd widths re-packed
  into byte-aligned containers.

Inputs may be numpy arrays or torch tensors; outputs are ``MPQTensor`` /
``MBWQTensor`` records on ``device`` (``None`` means ``cuda``), where the
unpacking and repacking run.
"""

from __future__ import annotations

import json
import mmap
import struct
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import packing
from ..ops.quant import decompress_gba_asym, decompress_gba_sym
from ..qtensor import MBWQTensor, MPQTensor

# safetensors dtype names ↔ torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {dt: name for name, dt in _ST_DTYPES.items()}


def _check_little_endian() -> None:
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors I/O here assumes a little-endian host")


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → ``{name: CPU tensor}``.

    The file is mapped copy-on-write and every tensor is a view of the
    mapping (``torch.frombuffer``): nothing is read until a tensor is used,
    and nothing is copied in host memory on the way to the card.  A tensor
    whose offset does not suit its element size is copied out."""
    _check_little_endian()
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = f.seek(0, 2)
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: unsupported safetensors dtype {info['dtype']!r}")
        shape = tuple(info["shape"])
        start, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = int(np.prod(shape, dtype=np.int64))
        if end - start != count * itemsize:
            raise ValueError(f"{name}: {end - start} bytes for shape {shape} of {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        if (base + start) % itemsize:
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - start, offset=base + start)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                         offset=base + start).reshape(shape)
    return out


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``{name: tensor}`` (torch tensors on any device, or numpy
    arrays) as a ``.safetensors`` file: the header padded with spaces to a
    multiple of 8 bytes, the tensors by element size (largest first), then
    name, so that each starts aligned to its element size."""
    _check_little_endian()
    items = []
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    tensors = {name: as_tensor(t, "cpu") if isinstance(t, np.ndarray) else t
               for name, t in tensors.items()}
    offset = 0
    for name in sorted(tensors, key=lambda k: (-tensors[k].element_size(), k)):
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        t = t.detach().contiguous().cpu()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        items.append(t)
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in items:
            if t.numel():
                # bytes as they lie in memory (bf16 has no numpy dtype)
                f.write(t.reshape(-1).view(torch.uint8).numpy())


def as_tensor(a, device, dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """A numpy array (ml_dtypes bfloat16 and uint32 words keep their bits,
    as bfloat16 and int32) or a torch tensor → a torch tensor on
    ``device``, in ``dtype`` if given; ``None`` stays ``None``."""
    if a is None:
        return None
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16"
        if bf16 or a.dtype == np.uint32:
            a = a.view(np.uint16 if bf16 else np.int32)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = a.copy()
        a = torch.from_numpy(a)
        a = a.view(torch.bfloat16) if bf16 else a
    a = a.to(device)
    return a if dtype is None else a.to(dtype)


def mpq_from_gptq(
    qweight, qzeros, scales, g_idx=None, w_bit: Optional[int] = None,
    group_size: Optional[int] = None, device: DeviceLike = None,
) -> MPQTensor:
    """Classical GPTQ tensors → asym ``MPQTensor`` (scales in f32).

    An act-order (``desc_act``) ``g_idx`` whose groups are equally
    populated is canonicalized here: the packed rows are stable-sorted by
    group (each group's rows keep GPTQ's order), ``g_idx`` is dropped and
    the stored → logical row map becomes ``q_perm``, so the kernels run the
    tensor after a gather of the activations.  A ragged ``g_idx`` is kept
    as it is (the plain dequantize serves it).  A sequential ``g_idx`` is
    dropped.  The unpack, sort and repack run on ``device``."""
    dev = resolve_device(device)
    n = qweight.shape[1]
    g = scales.shape[0]
    if w_bit is None:
        w_bit = 32 * qzeros.shape[1] // n
    k = qweight.shape[0] * 32 // w_bit
    if group_size is None:
        group_size = k // g
    gi = q_perm = None
    packed = as_tensor(qweight, dev, torch.int32)
    if g_idx is not None:
        gi_t = as_tensor(g_idx, dev, torch.int64)
        seq = torch.arange(k, device=dev) // group_size
        if not torch.equal(gi_t, seq):
            counts = torch.bincount(gi_t, minlength=g)
            if len(counts) == g and bool((counts == group_size).all()):
                order = torch.argsort(gi_t, stable=True)
                packed = packing.pack_rows(packing.unpack_rows(packed, w_bit)[order], w_bit)
                q_perm = order.to(torch.int32)
            else:
                gi = gi_t.to(torch.int32)
    return MPQTensor(
        packed=packed, scales=as_tensor(scales, dev, torch.float32),
        zeros=as_tensor(qzeros, dev, torch.int32), g_idx=gi, q_perm=q_perm, w_bit=w_bit,
        group_size=group_size, asym=True,
    )


def mpq_from_gba(
    qweight, tensors: Mapping[str, object], w_bit: int, group_size: int, asym: bool = False,
    dq_mode: int = 2, device: DeviceLike = None,
) -> MPQTensor:
    """GBA double-quantized tensors → ``MPQTensor``, scales (and sym zeros)
    decompressed.

    ``tensors`` holds the layer's buffers by name (``qstatistic``,
    ``qscales``, ``qzeros``, ``qscales_zeros``, ``qscales_scales``,
    ``qzeros_zeros``, ``qzeros_scales``), or precomputed ``scales`` and
    ``zeros`` (groups of 256 and more, where no double quantization is
    applied).  ``dq_mode=1`` (LLaMA-1-era GBA) keeps the scale affine per
    output channel ``(1, N, 1)``, ``dq_mode=2`` per dq-group ``(G, N/dqg,
    1)``."""
    dev = resolve_device(device)
    n = qweight.shape[1]
    packed = as_tensor(qweight, dev, torch.int32)

    def t(name):
        return as_tensor(tensors[name], dev)

    if "scales" in tensors and "zeros" in tensors:
        scales = as_tensor(tensors["scales"], dev, torch.float32)
        zeros = as_tensor(tensors["zeros"], dev, torch.float32)
    elif asym:
        scales = decompress_gba_asym(t("qscales"), t("qscales_zeros"), t("qscales_scales"),
                                     out_channels=n, w_bit=w_bit, dq_mode=dq_mode)
        return MPQTensor(packed=packed, scales=scales, zeros=as_tensor(tensors["qzeros"], dev,
                                                                     torch.int32),
                         w_bit=w_bit, group_size=group_size, asym=True)
    else:
        scales, zeros = decompress_gba_sym(
            t("qstatistic"), t("qzeros_zeros"), t("qzeros_scales"), t("qscales_zeros"),
            t("qscales_scales"), out_channels=n, dq_mode=dq_mode,
        )
    return MPQTensor(packed=packed, scales=scales, zeros=zeros, w_bit=w_bit,
                     group_size=group_size, asym=False)


# the exl2 widths; odd ones ride in the next byte-aligned container
EXL2_BITS = (2, 3, 4, 5, 6, 8)

_LOW32 = 0xFFFFFFFF


def unpack_exl2_bitstream(q_rows, bits: int) -> torch.Tensor:
    """exl2 sequentially packed rows → int32 codes ``(QR * 32 // bits, N)``.

    ``q_rows``: int32 ``(QR, N)``; per column the QR words form one
    little-endian bitstream along K, value ``i`` at bits ``[bits*i,
    bits*(i+1))`` (exllamav2's pre-shuffle layout).  A value that straddles
    two words takes its high bits from the next one.  Runs where the
    words lie (a numpy input on the CPU)."""
    u = as_tensor(q_rows, q_rows.device if isinstance(q_rows, torch.Tensor) else "cpu")
    u = u.to(torch.int64) & _LOW32
    qr = u.shape[0]
    k = qr * 32 // bits
    off = torch.arange(k, dtype=torch.int64, device=u.device) * bits
    word, shift = off // 32, (off % 32)[:, None]
    lo = u[word] >> shift
    spill = (off % 32 + bits > 32)[:, None]
    hi = torch.where(spill, u[torch.clamp(word + 1, max=qr - 1)] << (32 - shift), 0)
    return ((lo | hi) & ((1 << bits) - 1)).to(torch.int32)


def mbwq_from_exl2(
    q_weight, q_scale, q_scale_max, q_groups, q_invperm=None, channel_scale=None,
    device: DeviceLike = None,
) -> MBWQTensor:
    """exllamav2 tensors → ``MBWQTensor``, widths 2/3/4/5/6/8.

    exl2 packs eight 4-bit scale codes an int32 (``q_scale``) beside a
    per-group maximum (``q_scale_max``): ``scale = (code + 1)² ·
    q_scale_max / 256``.  ``q_groups`` lists ``[bits, first packed row]``
    per group; each run of groups of equal (bits, rows) becomes one
    segment, its codes unpacked from the bitstream and packed into the
    width's container (``code_bits`` keeps an odd width, ``zeros_mid`` the
    symmetric midpoint ``2**(bits-1) · scale``).  Rows are stored permuted;
    ``q_invperm`` (stored → logical) becomes ``q_perm``, with ``perm_block``
    and ``block_perm`` where it moves whole blocks."""
    dev = resolve_device(device)
    qw = as_tensor(q_weight, dev, torch.int32)
    qg = np.asarray(q_groups.cpu() if isinstance(q_groups, torch.Tensor) else q_groups,
                    np.int64).reshape(-1, 2)
    num_qrows = qw.shape[0]
    sc_codes = packing.unpack_cols(as_tensor(q_scale, dev, torch.int32), 4).float()
    sc_codes = sc_codes * sc_codes
    scale_max = as_tensor(q_scale_max, dev, torch.float32).reshape(-1) / 256.0

    starts = [int(s) for s in qg[:, 1]] + [num_qrows]
    groups = []
    for i in range(len(qg)):
        bits = int(qg[i, 0])
        if bits not in EXL2_BITS:
            raise ValueError(f"exl2 group {i}: unsupported bits={bits}")
        qs, qe = starts[i], starts[i + 1]
        groups.append((bits, (qe - qs) * 32 // bits, qs, qe, i))

    segs = []
    i = 0
    while i < len(groups):
        bits, rows = groups[i][0], groups[i][1]
        run = []
        while i < len(groups) and groups[i][:2] == (bits, rows):
            run.append(groups[i])
            i += 1
        codes = torch.cat([unpack_exl2_bitstream(qw[qs:qe], bits) for (_, _, qs, qe, _) in run])
        scales = torch.stack([sc_codes[gi] * scale_max[gi] for (*_, gi) in run])
        container = packing.CONTAINER_BITS[bits]
        segs.append(MPQTensor(
            packed=packing.pack_rows(codes, container), scales=scales,
            zeros=(2 ** (bits - 1)) * scales, w_bit=container, group_size=rows, asym=False,
            code_bits=None if container == bits else bits, zeros_mid=True,
        ))

    q_perm = block_perm = None
    perm_block = 0
    if q_invperm is not None:
        q_perm = as_tensor(q_invperm, dev, torch.int32)
        perm_block = detect_perm_block(q_perm)
        if perm_block:
            block_perm = (q_perm[::perm_block] // perm_block).to(torch.int32)
    cs = None if channel_scale is None else as_tensor(channel_scale, dev, torch.float32)
    return MBWQTensor(segments=tuple(segs), q_perm=q_perm, channel_scale=cs,
                      block_perm=block_perm, perm_block=perm_block)


def exl2_group_map(q_groups, num_qrows: int) -> torch.Tensor:
    """Per logical row, the flat pairs ``(group index, rows - row in group)``
    of exl2's ``make_group_map``, int16: the cross-check of
    :func:`mbwq_from_exl2`'s segment accounting."""
    qg = np.asarray(q_groups.cpu() if isinstance(q_groups, torch.Tensor) else q_groups,
                    np.int64).reshape(-1, 2)
    starts = [int(s) for s in qg[:, 1]] + [num_qrows]
    out = []
    for i in range(len(qg)):
        rows = (starts[i + 1] - starts[i]) * 32 // int(qg[i, 0])
        for j in range(rows):
            out += [i, rows - j]
    return torch.tensor(out, dtype=torch.int16)


def detect_perm_block(perm) -> int:
    """The largest block size b in 128, 64, 32 such that ``perm`` moves whole
    aligned blocks of b rows (``perm[i*b:(i+1)*b] == perm[i*b] + arange(b)``,
    ``perm[i*b] % b == 0``), else 0 (an arbitrary permutation)."""
    p = perm if isinstance(perm, torch.Tensor) else torch.from_numpy(np.asarray(perm))
    p = p.to(torch.int64)
    n = p.numel()
    for b in (128, 64, 32):
        if n % b:
            continue
        p2 = p.reshape(-1, b)
        if bool((p2[:, 0] % b == 0).all()) and bool(
            (p2 == p2[:, :1] + torch.arange(b, device=p.device)).all()
        ):
            return b
    return 0
