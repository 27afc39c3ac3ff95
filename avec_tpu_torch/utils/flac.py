"""Native FLAC codec, no external libraries (a copy of
avec_tpu/utils/flac.py, since the port imports nothing of `avec_tpu`; files
written by either package are byte-identical).

  * `write_flac`: 4096-sample frames, per-frame best fixed predictor
    (orders 0-4), Rice-coded residuals, CRC-8 / CRC-16 and the STREAMINFO
    MD5; standard FLAC that libFLAC / libsndfile read.
  * `read_flac`: CONSTANT, VERBATIM, FIXED (0-4) and LPC subframes, every
    stereo decorrelation mode, Rice / Rice2 partitions with escape codes.

The decoder checks each frame's CRC-16. Format: RFC 9639.
"""

import hashlib
import struct
from typing import List, Tuple

import numpy as np

_BLOCK_SIZE = 4096
_SR_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
             24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_BLOCKSIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                    512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13,
                    16384: 14, 32768: 15}

_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    """FLAC's extended-UTF-8 coding of a frame/sample number."""
    if n < 0x80:
        return bytes([n])
    for nbytes, first_max in ((2, 1 << 11), (3, 1 << 16), (4, 1 << 21),
                              (5, 1 << 26), (6, 1 << 31), (7, 1 << 36)):
        if n < first_max:
            out = bytearray(nbytes)
            for i in range(nbytes - 1, 0, -1):
                out[i] = 0x80 | (n & 0x3F)
                n >>= 6
            # Leading byte: nbytes ones, a zero, then the payload high bits.
            out[0] = ((0xFF00 >> nbytes) & 0xFF) | n
            return bytes(out)
    raise ValueError("number too large for FLAC utf8 coding")


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        if bits == 0:
            return
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, bits: int):
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zero bits then a one bit

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def read(self, bits: int) -> int:
        out = 0
        while bits > 0:
            if self.byte >= len(self.data):
                raise EOFError("flac bitstream exhausted")
            avail = 8 - self.bit
            take = min(bits, avail)
            cur = self.data[self.byte]
            out = (out << take) | ((cur >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            bits -= take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return out

    def read_signed(self, bits: int) -> int:
        v = self.read(bits)
        if v >= 1 << (bits - 1):
            v -= 1 << bits
        return v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1

    def read_utf8_number(self) -> int:
        first = self.read(8)
        if first < 0x80:
            return first
        nbytes = 0
        mask = 0x80
        while first & mask:
            nbytes += 1
            mask >>= 1
        n = first & (mask - 1)
        for _ in range(nbytes - 1):
            n = (n << 6) | (self.read(8) & 0x3F)
        return n


# ---------------------------------------------------------------- encoder

def _best_fixed_order(x: np.ndarray) -> Tuple[int, np.ndarray]:
    best_order, best_res, best_cost = 0, x, np.abs(x.astype(np.int64)).sum()
    res = x.astype(np.int64)
    for order in range(1, 5):
        res = np.diff(res)
        if len(res) == 0:
            break
        cost = np.abs(res).sum()
        if cost < best_cost:
            best_order, best_res, best_cost = order, res, cost
    if best_order:
        full = x.astype(np.int64)
        for _ in range(best_order):
            full = np.diff(full)
        best_res = full
    return best_order, best_res.astype(np.int64)


def _rice_param(residuals: np.ndarray) -> int:
    if len(residuals) == 0:
        return 0
    mean = np.abs(residuals).mean()
    k = 0
    while (1 << k) < mean and k < 30:
        k += 1
    return k


def _write_residual(w: _BitWriter, res: np.ndarray):
    """Single-partition Rice coding (partition order 0); escapes to raw
    bits when residuals are too wide for a 4-bit parameter."""
    param = _rice_param(res)
    folded = np.where(res >= 0, res * 2, -res * 2 - 1).astype(np.int64)
    if param <= 14:
        w.write(0, 2)   # coding method 0: 4-bit rice params
        w.write(0, 4)   # partition order 0
        w.write(param, 4)
        for u in folded:
            w.write_unary(int(u) >> param)
            w.write(int(u), param)
    else:
        w.write(1, 2)   # coding method 1: 5-bit rice params
        w.write(0, 4)
        if param <= 30:
            w.write(param, 5)
            for u in folded:
                w.write_unary(int(u) >> param)
                w.write(int(u), param)
        else:
            w.write(31, 5)  # escape: raw residuals
            nbits = max(int(np.abs(res).max()).bit_length() + 1, 1)
            w.write(nbits, 5)
            for v in res:
                w.write_signed(int(v), nbits)


def write_flac(path: str, audio: np.ndarray, sample_rate: int = 16000):
    """Encode mono float32 [-1, 1] (or int16) audio to 16-bit FLAC."""
    if audio.dtype == np.int16:
        pcm = audio.astype(np.int32)
    else:
        pcm = np.clip(np.asarray(audio, np.float64) * 32768.0,
                      -32768, 32767).astype(np.int32)
    pcm = pcm.reshape(-1)
    n = len(pcm)
    md5 = hashlib.md5(pcm.astype("<i2").tobytes()).digest()

    frames = []
    for f_idx, start in enumerate(range(0, n, _BLOCK_SIZE)):
        block = pcm[start: start + _BLOCK_SIZE]
        bs = len(block)
        w = _BitWriter()
        w.write(0b11111111111110, 14)
        w.write(0, 1)           # reserved
        w.write(0, 1)           # fixed blocksize strategy
        bs_code = _BLOCKSIZE_CODES.get(bs, 7)
        w.write(bs_code, 4)
        w.write(_SR_CODES.get(sample_rate, 0), 4)
        w.write(0, 4)           # channel assignment: 1 channel
        w.write(_BPS_CODES[16], 3)
        w.write(0, 1)           # reserved
        for b in _utf8_number(f_idx):
            w.write(b, 8)
        if bs_code == 7:
            w.write(bs - 1, 16)
        elif bs_code == 6:
            w.write(bs - 1, 8)
        assert w.nbits == 0, "frame header must be byte-aligned"
        w.write(_crc8(bytes(w.buf)), 8)

        # Subframe: constant, else best fixed predictor.
        if bs and np.all(block == block[0]):
            w.write(0, 1)
            w.write(0, 6)       # CONSTANT
            w.write(0, 1)       # no wasted bits
            w.write_signed(int(block[0]), 16)
        else:
            order, res = _best_fixed_order(block)
            w.write(0, 1)
            w.write(0b001000 | order, 6)  # FIXED
            w.write(0, 1)
            for v in block[:order]:
                w.write_signed(int(v), 16)
            _write_residual(w, res)

        w.align()
        body = w.bytes()
        frames.append(body + struct.pack(">H", _crc16(body)))

    payload = b"".join(frames)
    min_fs = min(len(f) for f in frames) if frames else 0
    max_fs = max(len(f) for f in frames) if frames else 0
    info = _BitWriter()
    info.write(_BLOCK_SIZE, 16)
    info.write(_BLOCK_SIZE, 16)
    info.write(min_fs, 24)
    info.write(max_fs, 24)
    info.write(sample_rate, 20)
    info.write(0, 3)            # channels - 1
    info.write(15, 5)           # bps - 1
    info.write(n, 36)
    streaminfo = info.bytes() + md5
    with open(path, "wb") as f:
        f.write(b"fLaC")
        f.write(bytes([0x80]) + len(streaminfo).to_bytes(3, "big"))
        f.write(streaminfo)
        f.write(payload)


# ---------------------------------------------------------------- decoder

def _read_residual(r: _BitReader, bs: int, order: int) -> np.ndarray:
    method = r.read(2)
    if method > 1:
        raise ValueError("reserved residual coding method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    porder = r.read(4)
    nparts = 1 << porder
    out: List[int] = []
    for p in range(nparts):
        count = (bs >> porder) - (order if p == 0 else 0)
        param = r.read(plen)
        if param == escape:
            nbits = r.read(5)
            for _ in range(count):
                out.append(r.read_signed(nbits) if nbits else 0)
        else:
            for _ in range(count):
                q = r.read_unary()
                u = (q << param) | (r.read(param) if param else 0)
                out.append((u >> 1) ^ -(u & 1))
    return np.asarray(out, np.int64)


def _decode_subframe(r: _BitReader, bs: int, bps: int) -> np.ndarray:
    if r.read(1) != 0:
        raise ValueError("bad subframe sync bit")
    sf_type = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = 1 + r.read_unary()
        bps -= wasted
    if sf_type == 0:            # CONSTANT
        out = np.full(bs, r.read_signed(bps), np.int64)
    elif sf_type == 1:          # VERBATIM
        out = np.asarray([r.read_signed(bps) for _ in range(bs)], np.int64)
    elif 8 <= sf_type <= 12:    # FIXED order 0-4
        order = sf_type - 8
        warm = [r.read_signed(bps) for _ in range(order)]
        res = _read_residual(r, bs, order)
        out = np.empty(bs, np.int64)
        out[:order] = warm
        coeffs = _FIXED_COEFFS[order]
        for i in range(order, bs):
            pred = 0
            for j, c in enumerate(coeffs):
                pred += c * out[i - 1 - j]
            out[i] = res[i - order] + pred
    elif sf_type >= 32:         # LPC
        order = (sf_type & 0x1F) + 1
        warm = [r.read_signed(bps) for _ in range(order)]
        precision = r.read(4) + 1
        shift = r.read_signed(5)
        coeffs = [r.read_signed(precision) for _ in range(order)]
        res = _read_residual(r, bs, order)
        out = np.empty(bs, np.int64)
        out[:order] = warm
        for i in range(order, bs):
            pred = 0
            for j, c in enumerate(coeffs):
                pred += c * out[i - 1 - j]
            out[i] = res[i - order] + (pred >> shift)
    else:
        raise ValueError(f"reserved subframe type {sf_type}")
    return out << wasted


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file to (float32 mono [-1, 1], sample_rate).

    Multi-channel audio is downmixed to the first channel (matching
    utils/media.read_audio's wav behavior)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC file")
    pos = 4
    sample_rate, nchan, bps, total = 16000, 1, 16, None
    while True:
        header = data[pos: pos + 4]
        last = header[0] & 0x80
        btype = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        pos += 4
        if btype == 0:
            r = _BitReader(data, pos)
            r.read(16); r.read(16); r.read(24); r.read(24)
            sample_rate = r.read(20)
            nchan = r.read(3) + 1
            bps = r.read(5) + 1
            total = r.read(36)
        pos += length
        if last:
            break

    channels: List[List[np.ndarray]] = [[] for _ in range(nchan)]
    got = 0
    while pos < len(data) and (total is None or got < total):
        r = _BitReader(data, pos)
        sync = r.read(14)
        if sync != 0b11111111111110:
            raise ValueError("lost frame sync")
        r.read(1)
        r.read(1)  # blocking strategy
        bs_code = r.read(4)
        sr_code = r.read(4)
        chan_code = r.read(4)
        bps_code = r.read(3)
        r.read(1)
        r.read_utf8_number()
        if bs_code == 6:
            bs = r.read(8) + 1
        elif bs_code == 7:
            bs = r.read(16) + 1
        elif bs_code == 1:
            bs = 192
        elif 2 <= bs_code <= 5:
            bs = 576 << (bs_code - 2)
        elif bs_code >= 8:
            bs = 256 << (bs_code - 8)
        else:
            raise ValueError("reserved block size code")
        if sr_code == 12:
            r.read(8)
        elif sr_code in (13, 14):
            r.read(16)
        frame_bps = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}.get(bps_code, bps)
        r.read(8)  # header CRC-8 (validated via the frame CRC-16 below)

        if chan_code <= 7:
            subs = [_decode_subframe(r, bs, frame_bps)
                    for _ in range(chan_code + 1)]
        elif chan_code == 8:    # left/side
            left = _decode_subframe(r, bs, frame_bps)
            side = _decode_subframe(r, bs, frame_bps + 1)
            subs = [left, left - side]
        elif chan_code == 9:    # right/side
            side = _decode_subframe(r, bs, frame_bps + 1)
            right = _decode_subframe(r, bs, frame_bps)
            subs = [right + side, right]
        elif chan_code == 10:   # mid/side
            mid = _decode_subframe(r, bs, frame_bps)
            side = _decode_subframe(r, bs, frame_bps + 1)
            m2 = (mid << 1) | (side & 1)
            subs = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError("reserved channel assignment")
        r.align()
        body = data[pos: r.byte]
        crc = struct.unpack(">H", data[r.byte: r.byte + 2])[0]
        if _crc16(body) != crc:
            raise ValueError(f"{path}: frame CRC mismatch")
        for c, s in enumerate(subs[: nchan]):
            channels[c].append(s)
        got += bs
        pos = r.byte + 2

    pcm = np.concatenate(channels[0]) if channels[0] else np.zeros(0, np.int64)
    if total is not None and total and len(pcm) > total:
        pcm = pcm[:total]
    scale = float(1 << (bps - 1))
    return (pcm.astype(np.float32) / scale), sample_rate
