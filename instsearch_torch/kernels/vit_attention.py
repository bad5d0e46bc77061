"""Forward attention for the ViT backbones (port of
``instsearch_tpu/kernels/vit_attention.py``): ``q, k, v [B, h, N, hd]``,
bf16 or f32, -> ``o [B, h, N, hd]`` in the same dtype, softmax scale
``1/sqrt(hd)``.

  * ``mha`` (K6): attention over whole rows. f32 logits, the softmax
    normalised in f32 over the N keys, then p rounded to v's dtype, p·v
    summed in f32, the result cast to the input dtype. The bf16 kernel
    reads q, k and v by TMA and runs both products by ``wgmma``, in
    persistent blocks: at N <= 256 a head's K and V are read into the SM
    once for all its query rows and each row's softmax is taken whole in
    registers; past 256 tokens it walks 128-key tiles twice (the row max
    and sum online, then p and p·v), so it takes any N.
  * ``flash_mha`` (K5): the same attention over key/value tiles of
    ``FLASH_KV_BLOCK`` keys with the online softmax: f32 logits, the ragged
    tail masked with the finite -1e30, running max and sum in f32, the
    UNNORMALISED p rounded to v's dtype before p·v, ``acc / l`` at the end.
    In bf16 it therefore differs from ``mha``, and p's rounding depends on
    where the tiles split, so the tiles are part of the result: 128 keys,
    the reference kernel's ``kv_block``, in the bf16 kernel and in the plain
    version (which takes others on request). The f32 kernel keeps tiles of
    64 keys: in f32 the tiling moves only the order of the sums.

Each wrapper launches its hand-written CUDA kernel
(``instsearch_torch/csrc/vit_attention.cu``) for CUDA tensors and takes its
plain PyTorch version (``mha_reference``, ``flash_mha_reference``) for CPU
tensors. A tensor the kernel cannot take raises; nothing falls back. Each
counts its kernel launches in ``.launches``. The kernels read q, k and v
through their strides (the model passes views of its qkv projection) and
write o as a view of ``[B, N, h, hd]`` memory, the layout the out
projection reads. ``check_attention`` is the rule they are held to against
their plain versions on the card. Forward only, as the reference:
extraction is inference, and training keeps the plain route.
"""
from __future__ import annotations

import functools
import math

import torch

HEAD_DIM = 64                 # the kernels' head dim (ViT-B/16, ViT-L/16)
SMEM_LIMIT = 232_448          # bytes of shared memory a Hopper block may use
FLASH_KV_BLOCK = 128          # keys per tile of K5 (the reference's kv_block)
_FLASH_NEG = -1e30            # finite mask: -inf would NaN the rescale
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# check_attention's bars
F32_TOL = 1e-5
BF16_STEP = 2.0 ** -7         # a bf16 step is at most 2^-7 of the value
# norm-relative: K5 and K6 read 5.3e-5 (197 tokens) to 3.6e-4 (16,385) on
# an H100 (chip_smoke.py phase 1), logits rounded to bf16 4.7e-3 to 5.0e-3
BF16_REL_TOL = 1e-3


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.dim() != 4:
        raise ValueError(f"q/k/v must be [B, h, N, hd]; got {tuple(q.shape)}")


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s arithmetic: ``exp(x - max) / sum``."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def mha_reference(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """K6's plain version (the reference's ``mha_reference``): f32 logits
    over the whole row, softmax in f32, p cast to v's dtype, p·v in f32."""
    _check_shapes(q, k, v)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = _softmax(logits / math.sqrt(q.shape[-1]))
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_block: int = FLASH_KV_BLOCK) -> torch.Tensor:
    """K5's plain version: the reference kernel's online softmax over the
    same key tiles of ``kv_block`` keys, step for step (a ragged last tile
    is sliced, not padded: the padded keys' masked logits add exact zeros
    there)."""
    _check_shapes(q, k, v)
    n, hd = q.shape[-2:]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), _FLASH_NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for s0 in range(0, n, kv_block):
        kt = k[:, :, s0:s0 + kv_block].float()
        vt = v[:, :, s0:s0 + kv_block].float()
        logits = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + torch.matmul(p.to(v.dtype).float(), vt)
        m = m_new
    return (acc / l).to(q.dtype)


def attention_error(out: torch.Tensor, want: torch.Tensor) -> dict:
    """How far ``out`` lies from the plain version's ``want``: the largest
    absolute difference (``max_abs_err``), the norm-relative one
    (``rel_err``, ``|out - want| / |want|`` over the whole tensor) and the
    largest element's difference over its bar (``bar_ratio``, see
    ``check_attention``)."""
    got, ref = out.float(), want.float()
    diff = (got - ref).abs()
    if out.dtype == torch.float32:
        bar = torch.full_like(ref, F32_TOL)
    else:
        rms = ref.square().mean().sqrt()
        bar = BF16_STEP * ref.abs() + 2 * BF16_STEP * rms
    return {"max_abs_err": diff.max().item(),
            "rel_err": (diff.norm() / ref.norm()).item(),
            "bar_ratio": (diff / bar).max().item()}


def check_attention(out: torch.Tensor, want: torch.Tensor) -> dict:
    """The rule K5 and K6 are held to against their plain versions on the
    same inputs. Raises ``AssertionError`` at a breach; returns
    ``attention_error``.

    * f32: every element within ``F32_TOL``; the two sides differ only in
      the order of their f32 sums.
    * bf16: both sides round p and the output to bf16 from f32 values that
      differ in their last f32 bits, so an output may land one bf16 step (at
      most 2^-7 of its size) from the plain version's, and a p one step of
      p, which moves the output by 2^-8 p_j |v_j|: at most 2^-6 of its rms
      for standard normal v (|v_j| < 4, p_j no more than the row's
      sqrt(sum p^2), about the rms of the output). Each element must be
      within ``2^-7 |want| + 2^-6 rms(want)``. Such flips are rare, so the
      whole must also be within ``BF16_REL_TOL`` in norm: a fault that moves
      every element by a fraction of a step (logits rounded to bf16) flips
      a large share of them and fails there.
    """
    if out.shape != want.shape:
        raise AssertionError(f"shape {tuple(out.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    err = attention_error(out, want)
    if err["bar_ratio"] > 1:
        bar = (f"{F32_TOL}" if out.dtype == torch.float32
               else "2^-7 |plain| + 2^-6 rms(plain)")
        raise AssertionError(f"an element differs by {err['bar_ratio']} "
                             f"times its bar ({bar}); largest difference "
                             f"{err['max_abs_err']}")
    if out.dtype != torch.float32 and err["rel_err"] > BF16_REL_TOL:
        raise AssertionError(f"norm-relative difference {err['rel_err']} > "
                             f"{BF16_REL_TOL}")
    return err


def _kernel_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> None:
    """Raise unless the kernel takes q, k and v as they are: one CUDA
    device, one dtype, head dim 64, hd contiguous, one set of strides over
    B, h and N (any: a view of the qkv projection is taken as it is), every
    row 16-byte aligned."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype} {k.dtype} {v.dtype}; the "
                         f"kernel takes q, k, v all bfloat16 or all float32")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]}; the kernel is "
                         f"built for head dim {HEAD_DIM} only")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{name}: B * h = {q.shape[0] * q.shape[1]} > 65535")
    align = 16 // q.element_size()
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {nm} on {t.device}; the kernel takes "
                             f"q, k, v on one CUDA device")
        if t.stride(-1) != 1 or t.stride() != q.stride():
            raise ValueError(f"{name}: {nm} strides {t.stride()}; the kernel "
                             f"takes q, k, v with one set of strides and the "
                             f"head dim contiguous")
        if t.data_ptr() % 16 or any(st % align for st in t.stride()[:3]):
            raise ValueError(f"{name}: {nm} rows are not 16-byte aligned")


# isf_mha's and isf_flash_mha's codes for a bf16 call they did not launch
# (no CUDA error)
_NO_ENCODER, _MAP_REFUSED = -1, -2


def _launch(fn, entry, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """Allocate the output, launch ``entry`` on the current stream, raise on
    its error code, count the launch on ``fn``. The output is a [B, h, N,
    hd] view of [B, N, h, hd] memory, so ``o.transpose(1, 2).reshape(B, N,
    h * hd)``, the merge of the heads, copies nothing."""
    b, h, n, hd = q.shape
    out = torch.empty((b, n, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, h, n, hd, _DTYPE_CODE[q.dtype], *q.stride()[:3],
                    *out.stride()[:3], stream)
    if err == _MAP_REFUSED:
        raise ValueError(f"{fn.__name__}: the CUDA tensor-map encoder "
                         f"refuses q/k/v with strides {q.stride()}")
    if err == _NO_ENCODER:
        raise RuntimeError(f"{fn.__name__}: libcuda has no "
                           f"cuTensorMapEncodeTiled (TMA needs CUDA 12)")
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err} (shape {tuple(q.shape)}, {q.dtype})")
    fn.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _mha_smem(n: int, dtype_code: int) -> int:
    """Shared memory K6 takes at ``n`` tokens (``isf_mha_smem``: bf16 one of
    its three forms, f32 growing with n), asked of the library once per
    (n, dtype)."""
    from . import _build
    return _build.load().isf_mha_smem(n, dtype_code)


def mha_kernel_attrs() -> dict:
    """The bf16 K6 kernel's registers a thread and its local memory (spills)
    in bytes a thread, the most over its three forms, as
    ``cudaFuncGetAttributes`` reads them. Builds the kernels on first
    use."""
    import ctypes
    from . import _build
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _build.load().isf_mha_attrs(ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes of the K6 kernel failed: "
                           f"CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value}


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K6: attention normalised over whole key rows; see the module
    docstring. On CUDA the bf16 kernel takes any N and reads q, k and v by
    TMA, so it raises ``ValueError`` if the CUDA tensor-map encoder refuses
    their strides; the f32 kernel, off the served path, keeps 16 rows of f32
    logits in shared memory and raises past about 3,264 tokens."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return mha_reference(q, k, v)
    _kernel_operands("mha", q, k, v)
    n = q.shape[2]
    from . import _build
    lib = _build.load()
    smem = _mha_smem(n, _DTYPE_CODE[q.dtype])
    if smem > SMEM_LIMIT:
        raise ValueError(f"mha: N={n} tokens need {smem} bytes of shared "
                         f"memory for the f32 kernel's logit rows (> "
                         f"{SMEM_LIMIT}); the f32 kernel is off the served "
                         f"path: use bfloat16, or flash_mha "
                         f"(vit_attention='flash')")
    return _launch(mha, lib.isf_mha, q, k, v)


def flash_mha(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """K5: tiled flash attention for long token counts (high-resolution
    extraction); the [N, N] logits never reach device memory. See the
    module docstring. On CUDA the bf16 kernel reads q, k and v by TMA
    through one tensor map each, and raises ``ValueError`` if the CUDA
    tensor-map encoder refuses their strides."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v)
    _kernel_operands("flash_mha", q, k, v)
    from . import _build
    return _launch(flash_mha, _build.load().isf_flash_mha, q, k, v)


# kernel launches; reset by whoever counts them
mha.launches = 0
flash_mha.launches = 0
