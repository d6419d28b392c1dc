"""The random streams of `jax.random` that the JAX package's serving and
CLM paths draw from, computed with torch integer ops.

A port-owned copy of JAX's default PRNG (threefry 2x32) in its
partitionable mode (`jax_threefry_partitionable`, on by default in JAX
0.9): the same seed gives the same keys, the same raw bits and the same
uniform values, bit for bit, and the same categorical draws. The serving
engine samples through `categorical` under `fold_in(key(seed), call)`, as
the JAX `ServingEngine` does; the trainer derives each micro-step's key as
`fold_in(key(seed + 1), step)` and NEFTune draws its noise with `uniform`,
as the JAX trainer and CLM do.

A key is a pair of 32-bit words held as Python ints (what
`jax.random.key_data` shows); key arithmetic runs on the host. `uniform`
and `categorical` are kernel wrappers: on the card each is one launch of a
hand-written kernel (`ops/kernels/csrc/prng.cu`, counted in `.launches`);
on the CPU each takes its plain version (`uniform_torch`,
`categorical_torch`), whose bits are torch integer ops with 32-bit words
carried in int64 and masked (torch's uint32 has few ops).

- Threefry 2x32: 20 rounds of add / rotate / xor in 5 groups of 4, a key
  injection after each group (`jax._src.prng._threefry2x32_lowering`).
- `key(seed)`: (0, seed & 0xFFFFFFFF): JAX's default 32-bit mode takes the
  seed as a 32-bit integer, so its high word is 0.
- `fold_in(key, data)`: threefry of the count pair (0, data).
- `split(key, n)`: key i is threefry of the count pair (0, i), both words.
- Bits of a shape: element i (row-major flat index) hashes the count pair
  (i >> 32, i & 0xFFFFFFFF); its 32 bits are the two output words XOR-ed,
  its 8 bits their low byte.
- A block of a shape (slices of its leading dims: a mesh rank's rows and
  sequence chunk) takes the bits of its elements' flat indices in the
  whole shape, so a rank draws only its part of the global batch's noise.
- `uniform`: the top mantissa bits under the exponent of 1.0, minus 1,
  times (maxval - minval), plus minval, at least minval, in the result's
  type; a 16-bit type with fewer than 8 mantissa bits (bf16) takes 8
  random bits. XLA fuses the fp32 multiply-add into one rounding (an FMA),
  while the bf16 one rounds after each op; `_fma_f32` rounds once.
- `categorical`: the argmax of logits plus Gumbel noise -log(-log(u)), u
  uniform on [tiny, 1) in the logits' type (JAX's default "low" mode).
"""

from __future__ import annotations

import ctypes

import torch

from llm_training_tpu_torch.ops.kernels import build

Key = tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotate_left(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """Threefry 2x32 of the count words (x0, x1) under `key`: Python ints
    or int64 tensors of 32-bit values. Returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotate_left(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _MASK
    return x0, x1


def key(seed: int) -> Key:
    """`jax.random.key(seed)`'s two words (JAX's default 32-bit mode)."""
    return (0, int(seed) & _MASK)


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)` for a 32-bit `data`."""
    return threefry2x32(key, 0, int(data) & _MASK)


def split(key: Key, num: int = 2) -> list[Key]:
    """`jax.random.split(key, num)`: `num` keys."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def _block_extents(shape, block) -> tuple[list[int], list[int]]:
    """(starts, extents) of `block` in `shape`: slices of step 1 over the
    leading dims, the dims after them whole."""
    block = tuple(block or ())
    if len(block) > len(shape):
        raise ValueError(f"a block of {len(block)} dims in a shape of {len(shape)}")
    starts, extents = [], []
    for d, size in enumerate(shape):
        start, stop, step = (block[d] if d < len(block) else slice(None)).indices(size)
        if step != 1:
            raise ValueError("a block takes slices of step 1")
        starts.append(start)
        extents.append(max(stop - start, 0))
    return starts, extents


def _strides(shape) -> list[int]:
    strides, stride = [], 1
    for size in reversed(shape):
        strides.append(stride)
        stride *= size
    return strides[::-1]


def _block_flat_index(shape, block, device) -> torch.Tensor:
    """The row-major flat index in `shape` of every element of `block`,
    shaped as the block."""
    starts, extents = _block_extents(shape, block)
    index = torch.zeros((), dtype=torch.int64, device=device)
    for start, extent, stride in zip(starts, extents, _strides(shape)):
        index = index[..., None] + torch.arange(start, start + extent, dtype=torch.int64,
                                                device=device) * stride
    return index


def _block_segments(shape, block) -> tuple[tuple[int, ...], int, int, int]:
    """(the block's shape, base, seg_len, seg_stride): element i of the
    block (row-major) is element base + (i // seg_len) * seg_stride +
    i % seg_len of the whole `shape`, as the uniform kernel takes it. The
    block must be one strided run of contiguous segments (a rank's rows
    and sequence chunk of a global batch are)."""
    starts, extents = _block_extents(shape, block)
    strides = _strides(shape)
    base = sum(start * stride for start, stride in zip(starts, strides))
    n = 1
    for extent in extents:
        n *= extent
    d, seg = len(shape) - 1, 1
    while d >= 0 and extents[d] == shape[d]:
        seg *= shape[d]
        d -= 1
    outer = [k for k in range(d) if extents[k] > 1] if d >= 0 else []
    if not outer:
        return tuple(extents), base, max(n, 1), 0
    if len(outer) > 1:
        raise ValueError(f"block {block} of {tuple(shape)} is not one strided run of segments")
    return tuple(extents), base, seg * extents[d], strides[outer[0]]


def random_bits(key: Key, shape, bit_width: int = 32, device=None, block=None) -> torch.Tensor:
    """`bit_width` (8 or 32) random bits per element of `shape`, as int64
    on `device`; with `block` (slices of the leading dims) only that
    block's, the same bits the whole draw has there."""
    index = _block_flat_index(tuple(shape), block, device)
    hi, lo = threefry2x32(key, index >> 32, index & _MASK)
    bits = hi ^ lo
    if bit_width == 8:
        bits = bits & 0xFF
    elif bit_width != 32:
        raise ValueError(f"bit_width must be 8 or 32, got {bit_width}")
    return bits


# mantissa bits, total bits, the int type of the same width, and 1.0's bits
_FLOAT_LAYOUT = {
    torch.float32: (23, 32, torch.int32, 0x3F800000),
    torch.bfloat16: (7, 16, torch.int16, 0x3F80),
}


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for fp32 tensors, rounded once to fp32: the product is
    exact in fp64, the sum is rounded to odd (TwoSum's error decides the
    last bit), and the round to fp32 from there is the single rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    odd = (s.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, toward), s)
    return s.float()


def uniform_torch(key: Key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
                  device=None, block=None) -> torch.Tensor:
    """`uniform`'s plain version: torch ops on `device`."""
    if dtype not in _FLOAT_LAYOUT:
        raise ValueError(f"uniform takes float32 or bfloat16, not {dtype}")
    nmant, nbits, int_type, one = _FLOAT_LAYOUT[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits, device, block)
    float_bits = (bits >> (rng_bits - nmant)) | one
    floats = float_bits.to(int_type).view(dtype) - torch.ones((), dtype=dtype, device=device)
    low = torch.as_tensor(minval, dtype=dtype, device=device)
    high = torch.as_tensor(maxval, dtype=dtype, device=device)
    if dtype == torch.float32:
        values = _fma_f32(floats, (high - low).expand_as(floats), low.expand_as(floats))
    else:
        values = floats * (high - low) + low
    return torch.maximum(low, values)


def gumbel(key: Key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, dtype)` in its default ("low") mode,
    in torch ops on `device`."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform_torch(key, shape, dtype, tiny, 1.0, device)))


def categorical_torch(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """`categorical`'s plain version: torch ops on the logits' device."""
    noise = gumbel(key, logits.shape, logits.dtype, logits.device)
    return torch.argmax(noise + logits, dim=-1)


# ---------------------------------------------------------------- the kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_declared = False


def _load() -> ctypes.CDLL:
    """The port's kernel library with these kernels' entry points declared."""
    global _declared
    lib = build.load()
    if not _declared:
        lib.prng_uniform_launch.argtypes = [
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,  # dtype, key, n
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # base, seg_len, seg_stride
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,  # low, high, out, stream
        ]
        lib.prng_uniform_launch.restype = ctypes.c_int
        lib.prng_gumbel_logits_launch.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,  # key, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # logits, out, stream
        ]
        lib.prng_gumbel_logits_launch.restype = ctypes.c_int
        _declared = True
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def uniform(key: Key, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None, block=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)` on `device`
    (float32 or bfloat16), bit for bit: one kernel launch on the card, the
    plain version on the CPU (the default). With `block` (slices of the
    leading dims: a rank's rows and sequence chunk) only that block is
    drawn, with the values the whole draw has there."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cpu":
        return uniform_torch(key, shape, dtype, minval, maxval, device, block)
    if device.type != "cuda":
        raise ValueError(f"uniform runs on cuda or cpu, not {device}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"uniform takes float32 or bfloat16, not {dtype}")
    local, base, seg_len, seg_stride = _block_segments(tuple(shape), block)
    out = torch.empty(local, dtype=dtype, device=device)
    # the bounds in the result's type, as JAX and the plain version take them
    low, high = (float(torch.tensor(x, dtype=dtype)) for x in (minval, maxval))
    with torch.cuda.device(device):
        err = _load().prng_uniform_launch(
            _DTYPE_CODES[dtype], key[0], key[1], out.numel(), base, seg_len, seg_stride, low,
            high, out.data_ptr(), _stream(device),
        )
    build.check_launch(err, "uniform")
    uniform.launches += 1
    return out


uniform.launches = 0


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)`: one draw per row of
    `logits` `[..., vocab]`, as int64. On the card the Gumbel noise and the
    sum with the logits are one kernel launch (fp32 logits), then an
    argmax; on the CPU, the plain version."""
    build.refuse_dtensor("categorical", logits)
    if logits.device.type == "cpu":
        return categorical_torch(key, logits)
    if logits.device.type != "cuda":
        raise ValueError(f"categorical runs on cuda or cpu, not {logits.device}")
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical on the card takes float32 logits, not {logits.dtype}")
    logits = logits.contiguous()
    perturbed = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        err = _load().prng_gumbel_logits_launch(
            key[0], key[1], logits.numel(), logits.data_ptr(), perturbed.data_ptr(),
            _stream(logits.device),
        )
    build.check_launch(err, "categorical")
    categorical.launches += 1
    return torch.argmax(perturbed, dim=-1)


categorical.launches = 0
