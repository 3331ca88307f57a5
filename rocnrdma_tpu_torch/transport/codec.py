"""Quantized streaming collectives — fp8/int8 on the wire with error
feedback (DESIGN.md §5k).

The streaming ring collectives fold frames on arrival straight out of
the wire buffer (``plugin.irecv_into(combine=ufunc)``); this module is
the compression layer that lives in exactly that hook: outgoing frames
are encoded to one byte per element (int8, or fp8-e4m3 via torch)
under a PER-FRAME scale header, and arriving frames are decoded-and-
folded straight out of the wire buffer into the destination — no
staging copy on either side beyond the encode output itself (which the
zero-copy gates do not count: it replaces 4x the wire bytes). On the
slow tcp plane a 4x payload cut beats any copy elimination left, which
is the whole motivation (ROADMAP).

Wire format of one encoded frame (all little-endian)::

    scale: f32 | n_elems: u32 | payload: n_elems bytes

``scale`` is a POWER OF TWO — the determinism rule that makes the
codec exact where it matters:

- ``decode(encode(x))`` is IDEMPOTENT for int8 (quantized values
  re-encode to byte-identical frames: the scale of a decoded frame is
  the same power of two, and the integer codes survive the round
  trip), so the allgather phase of a ring allreduce forwards reduced
  chunks losslessly and every rank lands bitwise-identical values;
- encode is a pure function of the frame's values — same seed, same
  traffic, same bytes on every run, which is what keeps same-seed
  chaos runs (and a fenced mid-bucket retry's re-encode) replay-equal
  with the codec active;
- the error-feedback residual (below) is EXACT for the input stage:
  the quantization-committed input ``q`` rides the wire losslessly on
  its first hop, so ``residual = x_eff - q`` is precisely what the
  wire dropped.

Error feedback (:class:`ResidualStore`): per rank, per (lane, verb,
shape, dtype), the quantization error is carried across rounds —
``x_eff = x + residual; q = roundtrip(x_eff); residual' = x_eff - q``
— and folded into the next round's send, so a training loop's gradient
sum converges on the fp32 trajectory instead of accumulating bias (the
moe-ffn convergence gate pins this). Residuals are EPOCH-SCOPED: a
heal/grow advances the group generation, and the first post-heal use
of a key resets its residual to zero, deterministically (recorded as a
``codec-residual-reset`` flight event; the chaos digest covers it).
Per-hop re-encode error of PARTIAL SUMS (reduce-scatter hops k >= 1)
is second-order — bounded by the codec's relative step per fold — and
deliberately not fed back; the residual captures the input stage,
which is where the bias lives.

Refusals are NAMED and flight-evented (the analyzer's codec rule pins
entry/abort coverage on every codec entry point): non-finite inputs
(inf/nan cannot ride a max-abs scale and would silently poison every
rank's reduction) and frame-shape mismatches both raise with the codec
and the reason in the message.

Codecs: ``"int8"`` (linear, qmax 127 — the fast path, the smoke-gated
wire codec) and ``"fp8"`` (fp8-e4m3 via ``torch.float8_e4m3fn``, qmax 448
— wider dynamic range per frame at a higher conversion cost; gated out
gracefully where torch lacks the dtype). ``"auto"`` is not a codec: it is the lane knob
value the tuner resolves per (plane, size) via
``HostWireModel.pick_codec``.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from rocnrdma_tpu_torch import lockwitness as _lockwitness
from rocnrdma_tpu_torch.metrics import VERBS as _VERB_LAT
from rocnrdma_tpu_torch.obs import trace as _trace

HDR = 8  # scale f32 | n_elems u32

# EF residual blocking: the roundtrip quantizes per EF_BLOCK elements
# (its own power-of-two scale per block, like the wire's per-frame
# scale) — a pure constant, identical on every rank. 4Mi elements is
# deliberately WHOLE-BUFFER for any realistic gradient: one scale per
# tensor (the per-tensor-scaled discipline of fp8 training recipes),
# which both streams fastest (no block-loop overhead) and makes the
# committed value's first wire hop EXACTLY lossless — every wire
# frame covers a SUBSET of an EF block, so the frame's max-abs scale
# is never coarser than the scale the values were committed at, and
# on-grid codes survive re-encode bit-for-bit (a finer pow2 scale
# keeps integer codes integer). A frame SPANNING differently-scaled
# EF blocks would re-quantize coarser and leak un-fed-back error;
# the cap is sized so that cannot happen below 16 MiB fp32 tensors.
EF_BLOCK = 1 << 22

# bound on the residual table: distinct (lane, verb, shape, dtype)
# keys a group carries residuals for; the oldest entry is evicted
# (deterministic insertion order) past this, flight-evented
RESIDUAL_CAP = 256

# relative encode+decode CPU cost per codec, against the reference
# (int8) cost the wire model's ``codec_s_per_b`` coefficient carries —
# measured on the host of an "NVIDIA H100 80GB HBM3, 700.00 W" (8-core
# Intel, family 6 model 207): fp8 with torch's conversion costs 3.16x
# int8's per byte, encode + decode-fold of a 1 MiB fp32 frame
# (rocnrdma_tpu_torch/results/host_tune_h100.json, "codec")
COST_FACTOR = {"int8": 1.0, "fp8": 3.2}

# the wire codec names, in deterministic pick order (the tuner's
# pick_codec walks these; order is part of the pick's purity contract)
WIRE_CODECS = ("int8", "fp8")

# the residual-store VERB key of the hierarchical schedule's cross-node
# leg: the node-local reduce-scatter's PARTIAL SUM is
# re-encoded for the slow inter-node hop, and that re-encode error is
# fed back through its own (lane, HIER_XLEG_VERB, shape, dtype)
# residual — keyed apart from the flat verbs' input-stage residuals, so
# a group mixing flat and hierarchical rounds never cross-feeds error
# between schedules. Epoch discipline is unchanged: the key resets
# deterministically on first post-heal use like every residual.
HIER_XLEG_VERB = "hier-xleg"


# ---------------------------------------------------------------------------
# Flight instrumentation (the analyzer's codec rule, pass #4h: every
# codec entry point records entry and abort events — a frame that
# refused to encode, or a header that refused to parse, must land on
# the timeline next to the collective it killed).
# ---------------------------------------------------------------------------


def _codec_entry(point: str, **ctx) -> float:
    """Record a codec entry point's start (``<point>-post``); returns
    the timestamp the done/abort side measures from. Recorded through
    the causal tracer's stamper, so an encode inside a sampled op span
    lands in that op's encode attribution bucket."""
    _trace.record(point + "-post", **ctx)
    return time.perf_counter()


def _codec_done(point: str, t0: float, **ctx) -> None:
    """Record a codec entry point's completion (``<point>-done`` with
    the work as ``dur``) and feed the latency histogram — encode cost
    is a first-class attribution bucket, not wire residual."""
    dt = time.perf_counter() - t0
    _VERB_LAT.observe("codec:" + point, dt)
    _trace.record(point + "-done", dur=dt, **ctx)


def _codec_abort(point: str, why: str, **ctx) -> ValueError:
    """Record a codec refusal (``<point>-abort``) and return the named
    error for the caller to raise — the record-and-raise shape of the
    abort-path invariant."""
    _trace.record(point + "-abort", error=why, **ctx)
    return ValueError(f"codec {point} refused: {why}")


# per-thread scratch reuse for the wire hot paths: a fresh MiB-class
# allocation per frame is page-fault (and zero-fill) cost that swamps
# the arithmetic. Safe by the post contract: every send path copies
# (or encodes) the payload SYNCHRONOUSLY before isend/iwrite returns,
# so an encode output is dead the moment the post lands — the next
# frame may reuse it. Thread-local because concurrent lanes encode
# from their own threads.
_SCRATCH = threading.local()


def stash_payload(decoded_nbytes: int, dtype, payload: bytes) -> None:
    """The EF layer's second hint: the exact wire payload of the
    committed input, pre-built during the EF pass (one scale per
    buffer = one frame's scale by the §5k lossless rule, so the
    wire's own encode would reproduce these bytes bit-for-bit). The
    next single-frame hop-0 send matching (size, dtype) uses it and
    skips its encode; consumed once — a retry without the stash
    re-encodes to IDENTICAL bytes, so results cannot depend on which
    path ran."""
    _SCRATCH.stash = (int(decoded_nbytes), np.dtype(dtype).str, payload)


def take_stash() -> tuple | None:
    """Consume the stashed wire payload UNCONDITIONALLY — the stream
    engine pops it at entry (like the committed-input mark), because a
    stash can only describe the collective being issued right now: one
    left behind by a stream that could not use it (multi-frame hop 0,
    codec resolved off) must never survive into a later send. Returns
    ``(decoded_nbytes, dtype_str, payload)`` or None."""
    st = getattr(_SCRATCH, "stash", None)
    _SCRATCH.stash = None
    return st


def mark_input_committed() -> None:
    """The error-feedback layer's hint to the NEXT stream on this
    thread: the collective's input is already quantization-committed
    (EF ran ``roundtrip`` on it), so the exchange-and-fold schedule's
    hop-0 image commit would write back byte-identical values — pure
    cost. Consumed (once) at stream entry; a retry that re-runs the
    stream without the mark merely pays the redundant commit, with
    bit-identical results either way."""
    _SCRATCH.committed = True


def take_input_committed() -> bool:
    """Consume the committed-input mark (False when absent)."""
    v = getattr(_SCRATCH, "committed", False)
    _SCRATCH.committed = False
    return v


def _wire_scratch(nbytes: int) -> memoryview:
    """A reusable encode-output buffer of exactly ``nbytes``."""
    buf = getattr(_SCRATCH, "wire", None)
    if buf is None or len(buf) < nbytes:
        _SCRATCH.wire = buf = bytearray(max(nbytes, 1 << 16))
    return memoryview(buf)[:nbytes]


def _val_scratch(n: int, dtype) -> np.ndarray:
    """A reusable value-domain scratch of ``n`` ``dtype`` elements."""
    pool = getattr(_SCRATCH, "vals", None)
    if pool is None:
        _SCRATCH.vals = pool = {}
    key = np.dtype(dtype).str
    a = pool.get(key)
    if a is None or a.size < n:
        pool[key] = a = np.empty(max(n, 1 << 14), dtype)
    return a[:n]


def _pow2_scale(maxabs: float, qmax: float) -> float:
    """The frame scale: the smallest POWER OF TWO ``s`` with
    ``maxabs / s <= qmax`` (0.0 for an all-zero frame). Powers of two
    make the quantization grid exactly representable — division by the
    scale is exact, decoded values are ``code * s`` exactly, and a
    decoded frame re-encodes to the same scale — the idempotency the
    module docstring's determinism rules rest on. Clamped away from
    the subnormal floor so ``1/s`` can never overflow."""
    if maxabs == 0.0:
        return 0.0
    m, e = math.frexp(maxabs / qmax)  # maxabs/qmax = m * 2**e, m in [0.5, 1)
    if m == 0.5:
        e -= 1  # exact power of two: ceil(log2) is e-1
    return math.ldexp(1.0, max(-120, e))


class WireCodec:
    """One streaming compression scheme: per-frame scale header + one
    byte per element. Subclasses supply ``qmax`` and the two payload
    transforms (``_quantize`` / ``_payload_values``); everything else —
    header layout, finiteness refusal, idempotent scale discipline,
    flight instrumentation — is shared so the two codecs can never
    disagree on the wire format."""

    name: str = "?"
    qmax: float = 0.0

    # -- size arithmetic (the ONE definition both ends derive from) --------

    def encoded_nbytes(self, nbytes: int, itemsize: int) -> int:
        """Wire bytes of an encoded frame whose DECODED payload is
        ``nbytes`` bytes of ``itemsize``-byte elements — the sender's
        post size and the receiver's LG-routing/expectation arithmetic
        both read this, so the two ends agree by construction."""
        return HDR + nbytes // max(1, int(itemsize))

    @staticmethod
    def supports(dtype) -> bool:
        """Whether this dtype rides the codec at all: floating payloads
        compress; everything else (the int64 bitwise oracles, byte
        blobs) passes through uncompressed — BOTH ends derive the
        decision from the shared dtype, so the wire never disagrees."""
        return np.issubdtype(np.dtype(dtype), np.floating)

    # -- subclass surface ---------------------------------------------------

    def _quantize(self, scaled: np.ndarray) -> np.ndarray:
        """``scaled`` (values/scale, within ±qmax; MAY be mutated in
        place as scratch) -> 1-byte codes."""
        raise NotImplementedError

    def _payload_values(self, payload: np.ndarray, dtype) -> np.ndarray:
        """1-byte wire codes -> unscaled values in ``dtype``."""
        raise NotImplementedError

    def _apply(self, payload: np.ndarray, d: np.ndarray, scale: float,
               combine) -> None:
        """Decoded values of ``payload`` at ``scale`` landed into /
        folded with ``d`` — the generic two-pass shape; subclasses
        override with fused fast paths."""
        vals = self._payload_values(payload, d.dtype)
        vals *= d.dtype.type(scale)
        if combine is None:
            d[:] = vals
        else:
            combine(d, vals, out=d)

    @staticmethod
    def _maxabs(arr: np.ndarray) -> float:
        """max |arr| via a max/min reduction pair — two read passes, no
        |arr|-sized temp (the temp write is the expensive half on the
        frame-sized inputs the wire feeds through here)."""
        if not arr.size:
            return 0.0
        return max(float(arr.max()), -float(arr.min()))

    # -- the wire surface ---------------------------------------------------

    def encode(self, arr: np.ndarray, commit: np.ndarray | None = None
               ) -> bytearray:
        """One frame's values -> ``scale | n_elems | payload`` wire
        bytes. Pure function of ``arr``'s values (no clock, no RNG):
        a fenced mid-bucket retry re-encodes byte-identically, which
        is what keeps same-seed chaos runs digest-equal with the
        codec ON. Refuses non-finite input, NAMED — an inf/nan has no
        max-abs scale and would silently poison every rank.

        ``commit``: optional array (same shape/dtype as ``arr``) to
        receive the DECODED image of the encoded frame — what every
        receiver will hold. The streaming engine commits a fold hop's
        quantized image locally through this (the cross-rank-bitwise
        rule) at the cost of one multiply pass, not a full decode.

        The returned buffer is a PER-THREAD SCRATCH (valid until this
        thread's next encode): every post path copies the payload
        synchronously, so the wire never holds a reference past the
        call — callers that keep the bytes must copy them."""
        t0 = _codec_entry("frame-encode", codec=self.name, nbytes=arr.nbytes)
        maxabs = self._maxabs(arr)
        if not math.isfinite(maxabs):
            raise _codec_abort("frame-encode", "non-finite input (inf/nan)",
                              codec=self.name)
        scale = _pow2_scale(maxabs, self.qmax)
        out = _wire_scratch(HDR + arr.size)
        out[0:4] = np.float32(scale).tobytes()
        out[4:8] = int(arr.size).to_bytes(4, "little")
        if scale != 0.0:
            tmp = _val_scratch(arr.size, arr.dtype)
            np.multiply(arr, arr.dtype.type(1.0 / scale), out=tmp)
            self._store_codes(tmp, np.frombuffer(out, np.uint8, arr.size,
                                                 HDR), scale, commit)
        else:
            np.frombuffer(out, np.uint8, arr.size, HDR)[:] = 0
            if commit is not None:
                commit[:] = 0
        _codec_done("frame-encode", t0, codec=self.name, nbytes=arr.nbytes,
                    wire=len(out))
        return out

    def _store_codes(self, scaled: np.ndarray, codes_u8: np.ndarray,
                     scale: float, commit: np.ndarray | None) -> None:
        """Quantize ``scaled`` (values/scale; scratch, may be mutated)
        INTO the wire payload ``codes_u8``, and optionally write the
        decoded image into ``commit`` — the generic shape; subclasses
        fuse."""
        np.copyto(codes_u8, self._quantize(scaled).view(np.uint8))
        if commit is not None:
            self._apply(codes_u8, commit, scale, None)

    def decode_fold(self, src_u8: np.ndarray, dest_u8: np.ndarray,
                    dtype, combine=None) -> int:
        """Decode one arrived frame STRAIGHT OUT OF THE WIRE BUFFER
        (``src_u8``: a uint8 view of the posted recv buffer or the LG
        arena window) into ``dest_u8`` (a uint8 view of the caller's
        destination slice) — land when ``combine`` is None, fold in
        place otherwise. Returns the decoded byte count. The one write
        of the zero-copy receive path; a header that disagrees with
        the expectation refuses NAMED (a silent partial land would
        corrupt the reduction)."""
        t0 = _codec_entry("frame-decode", codec=self.name,
                          nbytes=len(src_u8))
        dtype = np.dtype(dtype)
        if len(src_u8) < HDR:
            raise _codec_abort("frame-decode",
                              f"short frame ({len(src_u8)} B < {HDR} B "
                              f"header)", codec=self.name)
        scale = float(np.frombuffer(src_u8[:4], "<f4")[0])
        n = int.from_bytes(src_u8[4:8], "little")
        nbytes = n * dtype.itemsize
        if len(src_u8) != HDR + n or nbytes != dest_u8.nbytes:
            raise _codec_abort(
                "frame-decode",
                f"frame shape mismatch: header says {n} elems "
                f"({nbytes} B decoded, {HDR + n} B wire), got "
                f"{len(src_u8)} B wire for a {dest_u8.nbytes} B "
                f"destination", codec=self.name)
        d = dest_u8.view(dtype)
        if scale == 0.0:
            # genuinely fold the zeros (a max/min reduction is not a
            # no-op against zeros), land them otherwise
            if combine is None:
                d[:] = 0
            else:
                combine(d, np.zeros(n, dtype), out=d)
        else:
            self._apply(np.frombuffer(src_u8, np.uint8, n, HDR), d,
                        scale, combine)
        _codec_done("frame-decode", t0, codec=self.name, nbytes=nbytes)
        return nbytes

    def roundtrip(self, arr: np.ndarray,
                  out: np.ndarray | None = None) -> np.ndarray:
        """``decode(encode(arr))`` at the value level, per EF_BLOCK
        elements (each block its own power-of-two scale, like the
        wire's per-frame scale): the quantization-committed value the
        error-feedback residual is computed against. Pure and
        deterministic; refuses non-finite input like :meth:`encode`.
        ``out``: optional same-size flat destination (the residual
        store's scratch reuse — fresh MiB allocations are page-fault
        cost on the per-round hot path)."""
        t0 = _codec_entry("ef-roundtrip", codec=self.name, nbytes=arr.nbytes)
        flat = np.ascontiguousarray(arr).ravel()
        out = np.empty_like(flat) if out is None else out.ravel()
        for off in range(0, max(1, flat.size), EF_BLOCK):
            b = flat[off:off + EF_BLOCK]
            maxabs = self._maxabs(b)
            if not math.isfinite(maxabs):
                raise _codec_abort("ef-roundtrip",
                                  "non-finite input (inf/nan)",
                                  codec=self.name)
            scale = _pow2_scale(maxabs, self.qmax)
            if scale == 0.0:
                out[off:off + EF_BLOCK] = 0
                continue
            self._roundtrip_block(b, scale, out[off:off + EF_BLOCK])
        _codec_done("ef-roundtrip", t0, codec=self.name, nbytes=arr.nbytes)
        return out.reshape(np.shape(arr))

    def _roundtrip_block(self, b: np.ndarray, scale: float,
                         out: np.ndarray, codes_u8=None) -> bool:
        """decode(encode(b)) at ``scale`` into ``out`` — the generic
        shape; subclasses override with fused fast paths (the values
        are what matter: by the power-of-two scale rules this IS what
        a wire receiver would decode). ``codes_u8``: optional wire-code
        destination; returns True when the codes were emitted (the
        generic shape declines — only fused subclasses emit)."""
        scaled = b * b.dtype.type(1.0 / scale)
        self._apply(self._quantize(scaled).view(np.uint8), out, scale,
                    None)
        return False

    def ef_update(self, x: np.ndarray, residual: np.ndarray | None,
                  q_out: np.ndarray, res_out: np.ndarray,
                  want_payload: bool = False) -> bytes | None:
        """ONE fused error-feedback round, blockwise (every pass of a
        block runs while it is cache-hot — the EF hot path the
        residual store rides): per EF_BLOCK,
        ``eff = x + residual`` (plain ``x`` on a fresh key), ``q =
        roundtrip(eff)`` into ``q_out``, ``residual' = eff - q`` into
        ``res_out``. All four arrays are flat and same-sized;
        ``res_out`` doubles as the eff scratch. Refuses non-finite
        input NAMED, like every encode path.

        ``want_payload``: when the whole buffer fits ONE EF block (so
        its scale IS the wire frame scale by the §5k lossless rule)
        and the codec supports a fused code emit, additionally return
        the exact WIRE PAYLOAD of ``q`` — what the wire's own encode
        would produce bit-for-bit — so a single-frame hop-0 send can
        skip its re-encode entirely."""
        t0 = _codec_entry("ef-update", codec=self.name, nbytes=x.nbytes)
        payload = None
        emit = want_payload and x.size <= EF_BLOCK
        for off in range(0, max(1, x.size), EF_BLOCK):
            xb = x[off:off + EF_BLOCK]
            effb = res_out[off:off + EF_BLOCK]
            if residual is None:
                effb[:] = xb
            else:
                np.add(xb, residual[off:off + EF_BLOCK], out=effb)
            maxabs = self._maxabs(effb)
            if not math.isfinite(maxabs):
                raise _codec_abort("ef-update",
                                  "non-finite input (inf/nan)",
                                  codec=self.name)
            scale = _pow2_scale(maxabs, self.qmax)
            qb = q_out[off:off + EF_BLOCK]
            codes = None
            if emit:
                buf = bytearray(HDR + xb.size)
                buf[0:4] = np.float32(scale).tobytes()
                buf[4:8] = int(xb.size).to_bytes(4, "little")
                codes = np.frombuffer(buf, np.uint8, xb.size, HDR)
            if scale == 0.0:
                qb[:] = 0
                if codes is not None:
                    payload = bytes(buf)
            else:
                emitted = self._roundtrip_block(effb, scale, qb,
                                                codes_u8=codes)
                if codes is not None and emitted:
                    payload = bytes(buf)
            np.subtract(effb, qb, out=effb)  # effb IS the residual block
        _codec_done("ef-update", t0, codec=self.name, nbytes=x.nbytes)
        return payload


class Int8Codec(WireCodec):
    """Linear int8: ``code = rint(x / scale)``, qmax 127. With the
    power-of-two scale the codes of a decoded frame survive a second
    encode bit-for-bit (idempotent roundtrip) — the codec the smoke
    gate runs. The hot paths are fused: quantize rounds in place on
    its scratch, decode-land is ONE multiply pass straight into the
    destination (int8 codes x scale with ``out=``, no temp), and the
    EF roundtrip never materializes int8 at all (rint keeps the codes
    exact in the float domain)."""

    name = "int8"
    qmax = 127.0

    def _quantize(self, scaled: np.ndarray) -> np.ndarray:
        np.rint(scaled, out=scaled)
        return scaled.astype(np.int8)

    def _payload_values(self, payload: np.ndarray, dtype) -> np.ndarray:
        return payload.view(np.int8).astype(dtype)

    def _apply(self, payload: np.ndarray, d: np.ndarray, scale: float,
               combine) -> None:
        codes = payload.view(np.int8)
        if combine is None:
            # fused decode-land: one pass, no temp
            np.multiply(codes, d.dtype.type(scale), out=d,
                        casting="unsafe")
        else:
            vals = _val_scratch(codes.size, d.dtype)
            np.multiply(codes, d.dtype.type(scale), out=vals,
                        casting="unsafe")
            combine(d, vals, out=d)

    def _store_codes(self, scaled: np.ndarray, codes_u8: np.ndarray,
                     scale: float, commit: np.ndarray | None) -> None:
        # fused: round in place on the scratch, cast-store straight
        # into the wire payload (no int8 temp); the commit image is
        # one multiply off the still-rounded scratch
        np.rint(scaled, out=scaled)
        np.copyto(codes_u8.view(np.int8), scaled, casting="unsafe")
        if commit is not None:
            np.multiply(scaled, scaled.dtype.type(scale), out=commit)

    def _roundtrip_block(self, b: np.ndarray, scale: float,
                         out: np.ndarray, codes_u8=None) -> bool:
        # rint(b/scale)*scale without the int8 round trip: the rounded
        # values are integers in [-127, 127], exactly the codes — the
        # int8 cast cannot change them, so the float-domain product IS
        # decode(encode(b)) (3 passes instead of 5). ``codes_u8`` gets
        # the int8 wire codes cast-stored off the rounded scratch (one
        # extra pass) — the fused payload emit the EF stash rides.
        np.multiply(b, b.dtype.type(1.0 / scale), out=out)
        np.rint(out, out=out)
        if codes_u8 is not None:
            np.copyto(codes_u8.view(np.int8), out, casting="unsafe")
        np.multiply(out, b.dtype.type(scale), out=out)
        return codes_u8 is not None


# elements a torch conversion runs on one thread (torch's GRAIN_SIZE)
_F8_PIECE = 32768


class Fp8E4M3Codec(WireCodec):
    """fp8-e4m3 (finite-only, qmax 448) via ``torch.float8_e4m3fn`` —
    wider per-frame dynamic range than int8. Encode converts a CPU
    tensor that is a view of the numpy scratch; decode reads the 256
    codes' values from a table built once from torch's own conversion
    (exact: every e4m3 value is exact in fp32 and fp64). Construction
    probes torch once; a machine without the dtype gets a NAMED refusal
    at get() time, not an ImportError mid-collective.

    Both torch and ``ml_dtypes`` (the reference's conversion) round a
    float64 through float32 first, and agree up to 464 in magnitude; past
    it torch saturates to ±448 where ``ml_dtypes`` gives NaN, so
    ``_quantize`` writes the NaN code (0x7f, 0xff by sign) there itself and
    every float32 or float64 value encodes as the reference's. The
    per-frame scale keeps every scaled value within ±qmax anyway."""

    name = "fp8"
    qmax = 448.0

    def __init__(self):
        import torch
        f8 = getattr(torch, "float8_e4m3fn", None)
        if f8 is None:
            raise ImportError(f"torch {torch.__version__} has no float8_e4m3fn")
        self._torch = torch
        self._f8 = f8
        codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        vals = codes.view(f8).to(torch.float32).numpy()
        # the two NaN codes (0x7f, 0xff) decode to the signed quiet NaN
        # numpy's casts give, not torch's payload bits, so a decoded NaN
        # is the same bytes as the reference's
        nan = np.isnan(vals)
        vals[nan] = np.copysign(np.float32(np.nan), vals[nan])
        self._lut = {np.dtype(np.float32): vals,
                     np.dtype(np.float64): vals.astype(np.float64)}

    def _quantize(self, scaled: np.ndarray) -> np.ndarray:
        # converted in pieces at torch's parallel grain: one frame is a
        # rank's share of the host's cores, and torch's intra-op threads
        # would contend with every rank's wire pumps for them
        flat = np.ascontiguousarray(scaled).ravel()
        codes = np.empty(flat.size, np.uint8)
        src = self._torch.from_numpy(flat)
        dst = self._torch.from_numpy(codes).view(self._f8)
        for off in range(0, flat.size, _F8_PIECE):
            dst[off:off + _F8_PIECE].copy_(src[off:off + _F8_PIECE])
        # past 464 in float32 magnitude (inf included) the reference's NaN,
        # not torch's saturated ±448; frames never get there, so two
        # reductions decide whether to look
        if flat.size and (flat.max() > 464 or flat.min() < -464):
            with np.errstate(over="ignore"):  # a float64 past float32's range: inf
                big = np.abs(flat.astype(np.float32, copy=False)) > 464
            codes[big] = np.where(np.signbit(flat[big]), 0xFF, 0x7F)
        return codes.reshape(np.shape(scaled))

    def _payload_values(self, payload: np.ndarray, dtype) -> np.ndarray:
        lut = self._lut.get(np.dtype(dtype))
        if lut is None:
            lut = self._lut[np.dtype(np.float32)].astype(dtype)
        return lut[payload.view(np.uint8)]


_CODECS: dict[str, WireCodec] = {}
_CODECS_LOCK = _lockwitness.make_lock("codec.py::_CODECS_LOCK")


def get(name: str) -> WireCodec:
    """THE codec instance for ``name`` ("int8" / "fp8"), one per
    process (codecs are stateless — the instance is just the wire
    format). Unknown names and unavailable backends refuse NAMED."""
    with _CODECS_LOCK:
        c = _CODECS.get(name)
        if c is None:
            if name == "int8":
                c = Int8Codec()
            elif name == "fp8":
                try:
                    c = Fp8E4M3Codec()
                except ImportError as e:
                    raise ValueError(
                        f"codec 'fp8' unavailable: torch.float8_e4m3fn "
                        f"not importable on this machine ({e}); use "
                        f"'int8'") from e
            else:
                raise ValueError(
                    f"unknown codec {name!r}; know {list(WIRE_CODECS)} "
                    f"(or 'auto' as the LANE knob — the tuner resolves "
                    f"it per (plane, size))")
            _CODECS[name] = c
        return c


def validate_name(name) -> str | None:
    """Validate a lane's ``codec=`` knob at OPEN time (fail fast at
    ``channel()``, not mid-collective): None passes through, "auto"
    is the tuner-resolved sentinel, anything else must name a codec
    this machine can construct."""
    if name is None:
        return None
    name = str(name)
    if name != "auto":
        get(name)  # raises named on unknown/unavailable
    return name


# ---------------------------------------------------------------------------
# Error feedback: the per-rank residual carried across rounds.
# ---------------------------------------------------------------------------


class ResidualStore:
    """Per-rank error-feedback state: key -> (epoch, residual array).

    :meth:`feedback` is the one entry point the collective layer calls
    before a quantized reducing collective: it folds the carried
    residual into the input, quantization-commits the result through
    the codec's roundtrip, and returns ``(q, residual')`` — the caller
    runs the collective on ``q`` and calls :meth:`commit` only after
    the collective COMMITS (an aborted attempt leaves the carried
    residual untouched, so a heal-and-retry is exactly-once for the
    residual too).

    Epoch discipline: entries remember the group epoch they were
    committed under; a use under any OTHER epoch resets the key to
    zero first, deterministically (a healed rank's residual restarts —
    recorded as ``codec-residual-reset``, and :meth:`digest` covers
    the state so two same-seed chaos runs pin it replay-equal).
    """

    def __init__(self, cap: int = RESIDUAL_CAP):
        self._lock = _lockwitness.make_lock("codec.py::ResidualStore._lock")
        self._cap = max(1, cap)
        # key -> [epoch, residual, q_scratch, eff_scratch]: the two
        # scratch buffers are the per-key steady state — a round's
        # x_eff/q live in them, so the per-op hot path allocates
        # NOTHING after a key's first use (fresh MiB allocations are
        # page-fault cost). Safe because a lane serializes its own
        # collectives (the per-lane mutex) and q never escapes: the
        # ring copies its input at entry.
        self._entries: dict[tuple, list] = {}

    def feedback(self, key: tuple, x: np.ndarray, epoch: int,
                 codec: WireCodec, want_payload: bool = False) -> tuple:
        """-> ``(q, residual')``: ``x_eff = x + residual`` (zero on a
        fresh or epoch-reset key), ``q = codec.roundtrip(x_eff)``,
        ``residual' = x_eff - q``. The STORED residual is only read —
        nothing the store holds mutates until :meth:`commit`, so an
        aborted collective leaves the carried state untouched."""
        with self._lock:
            cur = self._entries.get(key)
        if cur is not None and cur[0] != epoch:
            _trace.record("codec-residual-reset", epoch=epoch,
                          stale_epoch=cur[0], nbytes=cur[1].nbytes)
            cur = None
        x = np.ascontiguousarray(x)
        flat = x.ravel()
        residual = cur[1] if cur is not None else None
        q_scratch = cur[2] if cur is not None else None
        eff_scratch = cur[3] if cur is not None else None
        q_out = (q_scratch if q_scratch is not None
                 else np.empty_like(flat)).ravel()
        res_out = (eff_scratch if eff_scratch is not None
                   else np.empty_like(flat)).ravel()
        payload = codec.ef_update(
            flat, residual.ravel() if residual is not None else None,
            q_out, res_out, want_payload=want_payload)
        if want_payload:
            return (q_out.reshape(x.shape), res_out.reshape(x.shape),
                    payload)
        return q_out.reshape(x.shape), res_out.reshape(x.shape)

    def commit(self, key: tuple, epoch: int, residual: np.ndarray,
               q: np.ndarray | None = None) -> None:
        """Store ``residual`` for ``key`` under ``epoch`` — called
        after the collective committed (the exactly-once boundary).
        ``q`` (the round's wire value) becomes the key's reusable
        scratch; the superseded residual buffer becomes the next
        round's x_eff scratch."""
        with self._lock:
            old = self._entries.pop(key, None)  # re-insert: LRU order
            self._entries[key] = [int(epoch), residual, q,
                                  old[1] if old is not None else None]
            # bounded eviction (a count, not a wait: the deadline
            # discipline is for blocking loops)
            for _ in range(max(0, len(self._entries) - self._cap)):
                stale = next(iter(self._entries))
                dropped = self._entries.pop(stale)
                _trace.record("codec-residual-evicted",
                              nbytes=dropped[1].nbytes)

    def digest(self) -> str:
        """Stable sha256 over the store's state (keys, epochs, exact
        residual bytes) — the replay-equality hook the chaos harness
        prints (CODECLOG): two same-seed runs must digest identically,
        including the deterministic post-heal resets."""
        import hashlib
        with self._lock:
            items = sorted((repr(k), ent[0], ent[1].tobytes())
                           for k, ent in self._entries.items())
        h = hashlib.sha256()
        for k, e, b in items:
            h.update(k.encode())
            h.update(str(e).encode())
            h.update(b)
        return h.hexdigest()

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
