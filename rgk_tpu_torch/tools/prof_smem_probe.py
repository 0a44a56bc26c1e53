"""P1: what the card's shared memory holds (port of the reference's
tools/prof_smem_probe.py, whose three questions were asked of the TPU's
scalar memory; kernels in csrc/probes.cu).

    python -m rgk_tpu_torch.tools.prof_smem_probe

1. `smem_ceiling`: the largest dynamic shared memory one block of 1024
   threads launches with.  Each size is opted in first
   (cudaFuncSetAttribute), in STEP (16 KB) steps up to the card's
   opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin), then the
   limit itself and one step past it.  A refused size comes back as the
   launch's error code, which is reported: the probe does not stop.
2. `unpack`: the u16 fixed-point unpack (x - hi) * lo of the word
   (2 << 16) | 5 on x = 3, which gives 5.0.
3. `row_copy`: row 3 of an i32 [8, n] table (0 .. 8n-1) copied into
   shared memory with cp.async from a dynamic offset; every thread then
   reads its last word, 4n - 1.  n = 15593 and 31251, as the reference;
   the question is whether one octant's link page fits (the 995,628-
   triangle colonnade's is 31,115 nodes).

Each wrapper launches its kernel for a CUDA tensor, or raises, and takes
its plain version for a CPU tensor.  `launches` counts kernel launches
that ran; nothing else adds to it.  Without a CUDA device `main` exits
with 2.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import kernels

THREADS = 1024
STEP = 16 * 1024           # bytes between the shared-memory sizes tried
UNPACK_WORD, UNPACK_X, UNPACK_WANT = (2 << 16) | 5, 3.0, 5.0
ROW, ROW_SIZES = 3, (15593, 31251)
COLONNADE_PAGE = 31_115    # nodes of the 995,628-triangle colonnade's tree

launches = {"smem": 0, "unpack": 0, "row_copy": 0}


def _lib_stream(dev):
    return kernels.load(), torch.cuda.current_stream(dev).cuda_stream


def _cuda(x, what):
    if x.device.type != "cuda":
        raise RuntimeError(f"no {what} probe kernel for {x.device}")


# ------------------------------------------------- 1. the shared-memory size

def smem_plain(x, n_words: int):
    """x f32 [1024] -> x + x[0] truncated to an integer, as the kernel
    stores it in the last of its `n_words` shared words and reads it
    back."""
    del n_words
    return x + torch.trunc(x[0])


def try_smem(x, n_words: int):
    """-> (out f32 [1024], cudaError as int) of the probe kernel with
    `n_words` words of dynamic shared memory.  A size the card refuses
    gives its error code and leaves `out` unwritten."""
    _cuda(x, "shared-memory")
    lib, stream = _lib_stream(x.device)
    out = torch.zeros_like(x)
    with torch.cuda.device(x.device):
        rc = lib.rgk_probe_smem(x.data_ptr(), out.data_ptr(), n_words, stream)
    if rc == 0:
        launches["smem"] += 1
    return out, rc


def smem(x, n_words: int):
    """The probe at one size: the kernel on a CUDA tensor (raises if the
    card refuses it), `smem_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return smem_plain(x, n_words)
    out, rc = try_smem(x, n_words)
    kernels.check_launch(rc, "shared-memory probe")
    return out


def optin_bytes(dev) -> int:
    """The card's opt-in ceiling of dynamic shared memory per block."""
    lib, _ = _lib_stream(dev)
    b = lib.rgk_device_smem_optin(dev.index or 0)
    if b < 0:
        raise RuntimeError(f"the opt-in query failed: cudaError {-b}")
    return b


def smem_ceiling(dev):
    """-> (opt-in bytes, [(bytes, cudaError, output equal to the plain
    version's)]) over the sizes of the module doc."""
    limit = optin_bytes(dev)
    sizes = list(range(STEP, limit, STEP)) + [limit, limit + STEP]
    x = torch.arange(THREADS, dtype=torch.float32, device=dev) * 0.5 + 7.0
    want = smem_plain(x, 1)
    rows = []
    for b in sizes:
        out, rc = try_smem(x, b // 4)
        torch.cuda.synchronize(dev)
        rows.append((b, rc, rc == 0 and bool(torch.equal(out, want))))
    return limit, rows


# ----------------------------------------------------------- 2. the unpack

def unpack_plain(w, x):
    """w i32 [1], x f32 [1024] -> (x - hi) * lo of the word's u16
    halves."""
    word = w.to(torch.int64)[0] & 0xFFFFFFFF
    hi = ((word >> 16) & 0xFFFF).to(torch.float32)
    lo = (word & 0xFFFF).to(torch.float32)
    return (x - hi) * lo


def unpack(w, x):
    if x.device.type == "cpu":
        return unpack_plain(w, x)
    _cuda(x, "unpack")
    lib, stream = _lib_stream(x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.rgk_probe_unpack(w.data_ptr(), x.data_ptr(), out.data_ptr(),
                                  stream)
    kernels.check_launch(rc, "unpack probe")
    launches["unpack"] += 1
    return out


def unpack_inputs(dev):
    return (torch.tensor([UNPACK_WORD], dtype=torch.int32, device=dev),
            torch.full((THREADS,), UNPACK_X, dtype=torch.float32, device=dev))


# ------------------------------------------------------ 3. the row copy

def row_copy_plain(table, row: int):
    """table i32 [8, n] -> i32 [1024], every entry table[row, n - 1]."""
    return table[row, -1].expand(THREADS).clone()


def row_copy(table, row: int = ROW):
    if table.dim() != 2 or table.shape[0] != 8 or table.dtype != torch.int32 \
            or not table.is_contiguous():
        raise ValueError(f"table must be contiguous int32 [8, n], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if table.device.type == "cpu":
        return row_copy_plain(table, row)
    _cuda(table, "row-copy")
    lib, stream = _lib_stream(table.device)
    out = torch.empty(THREADS, dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        rc = lib.rgk_probe_row_copy(table.data_ptr(), table.shape[1], row,
                                    out.data_ptr(), stream)
    kernels.check_launch(rc, "row-copy probe")
    launches["row_copy"] += 1
    return out


def row_table(n: int, dev):
    return torch.arange(8 * n, dtype=torch.int32, device=dev).view(8, n)


# ------------------------------------------------------------ entry point

def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Probe the card's dynamic shared memory per block, the "
        "u16 fixed-point unpack and a cp.async row copy (P1).")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_smem_probe: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}")
    limit, rows = smem_ceiling(dev)
    print(f"dynamic shared memory per block, opt-in limit {limit} bytes "
          f"({limit / 1024:g} KB):")
    ok = True
    for b, rc, same in rows:
        if rc == 0:
            print(f"  {b / 1024:g} KB: OK{'' if same else ' but WRONG output'}")
        else:
            msg = kernels.load().rgk_cuda_error_string(rc).decode()
            print(f"  {b / 1024:g} KB: refused (cudaError {rc}: {msg})")
        ok &= (rc == 0 and same) if b <= limit else rc != 0
    w, x = unpack_inputs(dev)
    r = unpack(w, x)
    good = bool((r == UNPACK_WANT).all())
    print(f"u16 fixed-point unpack: {'OK' if good else f'WRONG {r[0]}'}")
    ok &= good
    for n in ROW_SIZES:
        r = row_copy(row_table(n, dev), ROW)
        good = bool((r == 4 * n - 1).all())
        fits = 4 * n <= limit
        print(f"octant-row copy (n={n}, {4 * n} bytes): "
              f"{'OK' if good else f'WRONG {r[0]}'}; "
              f"{'fits' if fits else 'does not fit'} one block")
        ok &= good
    print(f"colonnade link page: {COLONNADE_PAGE} nodes, "
          f"{4 * COLONNADE_PAGE} bytes, "
          f"{'fits' if 4 * COLONNADE_PAGE <= limit else 'does not fit'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
