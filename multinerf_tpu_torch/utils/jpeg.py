"""JPEG decoding and encoding with numpy alone, for the host.

``decode_jpeg`` returns the uint8 array that Pillow's
``np.asarray(Image.open(f))`` gives (``multinerf_tpu/utils/io.py:23-26``),
bit for bit, by doing what libjpeg does with its default settings: Huffman
decoding of baseline (sequential) and progressive scans, 8-bit samples,
grayscale and YCbCr, any of 4:4:4, 4:2:2 and 4:2:0 (and 4:4:0), restart
intervals; the integer "islow" inverse DCT; "fancy" (triangular) chroma
upsampling; the fixed-point YCbCr -> RGB conversion.  Arithmetic coding,
12-bit samples, lossless and hierarchical JPEGs raise NotImplementedError.
APPn and COM segments are skipped (``io.load_exif`` reads the Exif one).

The entropy stage is Python, but no per-coefficient loop of it does more
than a table lookup: the bit stream is indexed as 32-bit windows at every
byte, and one lookup of the next 16 bits gives a Huffman symbol together
with its value bits (libjpeg-turbo's "fast AC" idea).  Everything after it
(dequantization, IDCT, upsampling, color) is vectorized over all blocks.

``encode_jpeg`` writes a baseline JPEG as libjpeg does for Pillow's
``save(f, 'JPEG', quality=q)``: JFIF header, the standard quantization
tables scaled by the IJG quality rule, the standard Huffman tables, 4:2:0
YCbCr or, on request, 4:4:4 (grayscale stays one component), the integer
forward DCT and
libjpeg-turbo's reciprocal quantizer; optionally an Exif APP1 segment.  Its
entropy coding is vectorized too.
"""

from __future__ import annotations

import re
import struct
import threading

import numpy as np

# jpeg_natural_order: the natural (row * 8 + column) index of the k-th
# coefficient in zigzag order.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])

# --- Integer DCTs (libjpeg's jidctint.c / jfdctint.c, CONST_BITS = 13). ------

_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137,
                            16069, 16819, 20995, 25172)


def _descale(x, n):
  return (x + (1 << (n - 1))) >> n


def _odd_part(t0, t1, t2, t3):
  """The odd part shared by both DCTs: t0..t3 are the inputs 7, 5, 3, 1
  (inverse) or 4, 5, 6, 7 (forward); returns their four rotated sums."""
  z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
  z5 = (z3 + z4) * _F1175
  t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
  z1, z2 = z1 * -_F0899, z2 * -_F2562
  z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
  return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _idct_1d(d, shift):
  """One pass of jpeg_idct_islow over axis 0 of d [8, ...] (int64)."""
  z1 = (d[2] + d[6]) * _F0541
  tmp2, tmp3 = z1 - d[6] * _F1847, z1 + d[2] * _F0765
  tmp0, tmp1 = (d[0] + d[4]) << _CONST_BITS, (d[0] - d[4]) << _CONST_BITS
  tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
  tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
  o0, o1, o2, o3 = _odd_part(d[7], d[5], d[3], d[1])
  return _descale(np.stack([tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
                            tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3]),
                  shift)


def _idct_range_table():
  """libjpeg's post-IDCT range limit, indexed by (value & 1023)."""
  t = np.zeros(1024, np.uint8)
  t[:128] = np.arange(128, 256)
  t[128:512] = 255
  t[896:] = np.arange(128)
  return t


_IDCT_RANGE = _idct_range_table()


def idct_islow(coefs):
  """Dequantized coefficients [N, 8, 8] (natural order) -> uint8 samples."""
  d = np.moveaxis(coefs.astype(np.int64), 1, 0)  # [8 rows, N, 8 cols]
  ws = _idct_1d(d, _CONST_BITS - _PASS1_BITS)  # Columns: over the rows.
  out = _idct_1d(np.moveaxis(ws, 2, 0),  # [8 cols, 8 rows, N]
                 _CONST_BITS + _PASS1_BITS + 3)  # [8 cols, 8 rows, N]
  return _IDCT_RANGE[np.transpose(out, (2, 1, 0)) & 1023]


def fdct_islow(samples):
  """Level-shifted samples [N, 8, 8] -> jpeg_fdct_islow's output (the DCT
  scaled by 8), int64."""
  def one_pass(d, first):
    t0, t7, t1, t6 = d[0] + d[7], d[0] - d[7], d[1] + d[6], d[1] - d[6]
    t2, t5, t3, t4 = d[2] + d[5], d[2] - d[5], d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    shift = _CONST_BITS - _PASS1_BITS if first else _CONST_BITS + _PASS1_BITS
    if first:
      o0, o4 = (t10 + t11) << _PASS1_BITS, (t10 - t11) << _PASS1_BITS
    else:
      o0 = _descale(t10 + t11, _PASS1_BITS)
      o4 = _descale(t10 - t11, _PASS1_BITS)
    z1 = (t12 + t13) * _F0541
    o2 = _descale(z1 + t13 * _F0765, shift)
    o6 = _descale(z1 - t12 * _F1847, shift)
    o7, o5, o3, o1 = (_descale(v, shift) for v in _odd_part(t4, t5, t6, t7))
    return np.stack([o0, o1, o2, o3, o4, o5, o6, o7])
  d = np.moveaxis(samples.astype(np.int64), 2, 0)  # Rows first: [8 c, N, 8 r]
  rows = one_pass(d, True)  # [8 u, N, 8 r]
  cols = one_pass(np.moveaxis(rows, 2, 0), False)  # [8 v, 8 u, N]
  return np.transpose(cols, (2, 0, 1))  # [N, v (row), u (column)]


# --- Huffman tables. -------------------------------------------------------


def _canonical_codes(bits, vals):
  """[(code, length, symbol)] of a DHT table (JPEG Annex C)."""
  out, code, k = [], 0, 0
  for length in range(1, 17):
    for _ in range(bits[length - 1]):
      out.append((code, length, vals[k]))
      code += 1
      k += 1
    code <<= 1
  return out


def _lookup(bits, vals):
  """(symbol, code length) of every 16-bit window of the stream, numpy;
  length 0 where no code starts the window."""
  sym = np.zeros(65536, np.int64)
  length = np.zeros(65536, np.int64)
  for code, n, s in _canonical_codes(bits, vals):
    sym[code << (16 - n):(code + 1) << (16 - n)] = s
    length[code << (16 - n):(code + 1) << (16 - n)] = n
  return sym, length


_FAST_CACHE = {}
_FAST_LOCK = threading.Lock()


def _fast_table(bits, vals, ac):
  """A list indexed by the next 16 bits of the stream: for DC tables
  (bits used, value, 0) and for AC tables (bits used, run, value, 0) where
  the code and its value bits fit in 16, else (code bits, ..., size): the
  value bits then follow.  An AC end of block (any size-0 symbol but ZRL)
  has run -1.  None where no code starts: a corrupt stream."""
  key = (bytes(bits), bytes(vals), ac)
  with _FAST_LOCK:
    table = _FAST_CACHE.get(key)
  if table is not None:
    return table
  sym, length = _lookup(bits, vals)
  peek = np.arange(65536, dtype=np.int64)
  size = sym & 15 if ac else sym
  run = sym >> 4
  fits = length + size <= 16
  extra = (peek >> np.clip(16 - length - size, 0, 16)) & ((1 << size) - 1)
  half = np.left_shift(1, np.maximum(size - 1, 0))
  value = np.where(size == 0, 0,
                   np.where(extra < half, extra - (1 << size) + 1, extra))
  nbits = np.where(fits, length + size, length)
  value = np.where(fits, value, 0)
  slow = np.where(fits, 0, size)
  if ac:
    run = np.where((size == 0) & (sym != 0xF0), -1, run)
    rows = zip(nbits.tolist(), run.tolist(), value.tolist(), slow.tolist())
  else:
    rows = zip(nbits.tolist(), value.tolist(), slow.tolist())
  table = [r if n else None for r, n in zip(rows, length.tolist())]
  with _FAST_LOCK:
    _FAST_CACHE[key] = table
  return table


def _symbol_table(bits, vals):
  """``_lookup``'s arrays as lists (the progressive scans' decoder)."""
  sym, length = _lookup(bits, vals)
  return sym.tolist(), length.tolist()


def bit_windows(segment):
  """32-bit big-endian windows starting at every byte of `segment` (zero
  padded past its end): bits p .. p + 24 are in windows[p >> 3]."""
  b = np.frombuffer(segment + bytes(8), np.uint8).astype(np.int64)
  return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


# --- Markers. --------------------------------------------------------------

_SOF_UNSUPPORTED = {
    0xC3: 'lossless', 0xC5: 'differential sequential',
    0xC6: 'differential progressive', 0xC7: 'differential lossless',
    0xC9: 'arithmetic-coded sequential', 0xCA: 'arithmetic-coded progressive',
    0xCB: 'arithmetic-coded lossless',
    0xCD: 'differential arithmetic-coded sequential',
    0xCE: 'differential arithmetic-coded progressive',
    0xCF: 'differential arithmetic-coded lossless'}
# The end of an entropy-coded segment: 0xFF and a byte that is neither a
# stuffed zero nor a restart marker.
_SEGMENT_END = re.compile(rb'\xff(?![\x00\xd0-\xd7])')
_RESTART = re.compile(rb'\xff[\xd0-\xd7]')


class _Component:

  def __init__(self, cid, h, v, tq):
    self.id, self.h, self.v, self.tq = cid, h, v, tq
    self.quant = None  # Natural-order table, latched at its first scan.


class _Frame:
  """A frame's geometry and the coefficients of every component, each a
  flat list of [blocks_y * blocks_x][64] ints in zigzag order."""

  def __init__(self, height, width, comps, progressive):
    self.height, self.width = height, width
    self.comps = comps
    self.progressive = progressive
    self.hmax = max(c.h for c in comps)
    self.vmax = max(c.v for c in comps)
    self.mcux = -(-width // (8 * self.hmax))
    self.mcuy = -(-height // (8 * self.vmax))
    for c in comps:
      c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v  # Stored block grid.
      c.w = -(-width * c.h // self.hmax)  # Samples of the component.
      c.hgt = -(-height * c.v // self.vmax)
      c.coefs = [0] * (c.bw * c.bh * 64)


def _units(frame, scomps):
  """(component index in the scan, coefficient base) of every data unit of
  a scan, in stream order, and the units per MCU."""
  if len(scomps) == 1:
    c = scomps[0]
    bx, by = -(-c.w // 8), -(-c.hgt // 8)
    idx = (np.arange(by)[:, None] * c.bw + np.arange(bx)[None, :]) * 64
    return [(0, int(i)) for i in idx.reshape(-1)], 1
  units = []
  for my in range(frame.mcuy):
    for mx in range(frame.mcux):
      for si, c in enumerate(scomps):
        for v in range(c.v):
          row = (my * c.v + v) * c.bw + mx * c.h
          units.extend((si, (row + h) * 64) for h in range(c.h))
  return units, sum(c.h * c.v for c in scomps)


def _intervals(data, pos, restart):
  """The restart intervals of the scan at data[pos:], unstuffed, and the
  position of the marker that ends it."""
  end = _SEGMENT_END.search(data, pos)
  stop = len(data) if end is None else end.start()
  parts = _RESTART.split(data[pos:stop]) if restart else [data[pos:stop]]
  return [p.replace(b'\xff\x00', b'\xff') for p in parts], stop


# --- Entropy decoding. -----------------------------------------------------


def _receive(win, p, size):
  """(signed value of the `size` bits at p, p + size)."""
  t = (win[p >> 3] >> (32 - (p & 7) - size)) & ((1 << size) - 1)
  return (t if t >> (size - 1) else t - (1 << size) + 1), p + size


def _decode_baseline(units, per_mcu, intervals, restart, coef_lists, dcs,
                     acs):
  """Sequential Huffman scan: every unit's 64 coefficients (zigzag)."""
  n_units = len(units)
  step = restart * per_mcu if restart else n_units
  u0 = 0
  for segment in intervals:
    if u0 >= n_units:
      break
    win = bit_windows(segment)
    p = 0
    pred = [0] * len(coef_lists)
    for si, base in units[u0:u0 + step]:
      out = coef_lists[si]
      dc = dcs[si]
      ac = acs[si]
      n, diff, slow = dc[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
      p += n
      if slow:
        diff, p = _receive(win, p, slow)
      pred[si] += diff
      out[base] = pred[si]
      k = 1
      while k < 64:
        n, run, value, slow = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        p += n
        if run < 0:
          break
        if slow:
          value, p = _receive(win, p, slow)
        k += run
        out[base + k] = value
        k += 1
    u0 += step


class _BitReader:
  """Bit-at-a-time access for the progressive scans."""

  def __init__(self, segment):
    self.win = bit_windows(segment)
    self.p = 0

  def bits(self, n):
    if n == 0:
      return 0
    p = self.p
    self.p = p + n
    return (self.win[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)

  def bit(self):
    p = self.p
    self.p = p + 1
    return (self.win[p >> 3] >> (31 - (p & 7))) & 1

  def symbol(self, table):
    sym, length = table
    i = (self.win[self.p >> 3] >> (16 - (self.p & 7))) & 0xFFFF
    if not length[i]:
      raise ValueError('corrupt JPEG: no Huffman code matches.')
    self.p += length[i]
    return sym[i]

  def value(self, size):
    t = self.bits(size)
    return t if size == 0 or t >> (size - 1) else t - (1 << size) + 1


def _decode_progressive(units, per_mcu, intervals, restart, coef_lists,
                        dc_tabs, ac_tabs, ss, se, ah, al):
  """One progressive scan (JPEG Annex G; libjpeg's jdphuff.c)."""
  n_units = len(units)
  step = restart * per_mcu if restart else n_units
  p1, m1 = 1 << al, -1 << al
  u0 = 0
  for segment in intervals:
    if u0 >= n_units:
      break
    rd = _BitReader(segment)
    pred = [0] * len(coef_lists)
    eobrun = 0
    for si, base in units[u0:u0 + step]:
      out = coef_lists[si]
      if ss == 0:  # DC scans.
        if ah == 0:
          s = rd.symbol(dc_tabs[si])
          pred[si] += rd.value(s)
          out[base] = pred[si] << al
        elif rd.bit():
          out[base] |= p1
        continue
      table = ac_tabs[si]
      if ah == 0:  # AC first scan.
        if eobrun:
          eobrun -= 1
          continue
        k = ss
        while k <= se:
          s = rd.symbol(table)
          r, s = s >> 4, s & 15
          if s:
            k += r
            out[base + k] = rd.value(s) << al
            k += 1
          elif r == 15:
            k += 16
          else:
            eobrun = (1 << r) - 1 + rd.bits(r)
            break
        continue
      k = ss  # AC refinement.
      if eobrun == 0:
        while k <= se:
          s = rd.symbol(table)
          r, s = s >> 4, s & 15
          if s:
            s = p1 if rd.bit() else m1
          elif r != 15:
            eobrun = (1 << r) + rd.bits(r)
            break
          while k <= se:
            c = out[base + k]
            if c:
              if rd.bit() and not c & p1:
                out[base + k] = c + (p1 if c >= 0 else m1)
            else:
              if r == 0:
                break
              r -= 1
            k += 1
          if s:
            out[base + k] = s
          k += 1
      if eobrun > 0:
        while k <= se:
          c = out[base + k]
          if c and rd.bit() and not c & p1:
            out[base + k] = c + (p1 if c >= 0 else m1)
          k += 1
        eobrun -= 1
    u0 += step


# --- Decoding. -------------------------------------------------------------


def _plane(comp):
  """A component's samples [hgt, w]: dequantize, IDCT, crop."""
  q = np.asarray(comp.coefs, np.int64).reshape(-1, 64)
  nat = np.empty_like(q)
  nat[:, ZIGZAG] = q
  nat *= comp.quant.reshape(1, 64)
  blocks = idct_islow(nat.reshape(-1, 8, 8))
  img = blocks.reshape(comp.bh, comp.bw, 8, 8).transpose(0, 2, 1, 3)
  return img.reshape(comp.bh * 8, comp.bw * 8)[:comp.hgt, :comp.w]


def _fancy_h2(cols, bias_prev, bias_next, scale):
  """libjpeg's triangular horizontal upsampling by 2 of `cols` [.., W]
  (edges replicated, as libjpeg-turbo's SIMD versions pad them)."""
  prev = np.concatenate([cols[..., :1], cols[..., :-1]], -1)
  nxt = np.concatenate([cols[..., 1:], cols[..., -1:]], -1)
  out = np.empty(cols.shape[:-1] + (2 * cols.shape[-1],), np.int64)
  out[..., 0::2] = (3 * cols + prev + bias_prev) >> scale
  out[..., 1::2] = (3 * cols + nxt + bias_next) >> scale
  return out


def _upsample(plane, fy, fx, height, width):
  """A chroma plane at full resolution, as libjpeg's upsamplers with
  do_fancy_upsampling: h2v1, h2v2 (wider than 2 samples) and h1v2
  triangular, other integer factors by replication."""
  s = plane.astype(np.int64)
  if (fx, fy) == (2, 1) and s.shape[1] > 2:
    up = _fancy_h2(s, 1, 2, 2)
  elif (fx, fy) == (2, 2) and s.shape[1] > 2:
    above = np.concatenate([s[:1], s[:-1]], 0)
    below = np.concatenate([s[1:], s[-1:]], 0)
    rows = np.empty((2 * s.shape[0], s.shape[1]), np.int64)
    rows[0::2] = 3 * s + above
    rows[1::2] = 3 * s + below
    up = _fancy_h2(rows, 8, 7, 4)
  elif (fx, fy) == (1, 2):
    above = np.concatenate([s[:1], s[:-1]], 0)
    below = np.concatenate([s[1:], s[-1:]], 0)
    up = np.empty((2 * s.shape[0], s.shape[1]), np.int64)
    up[0::2] = (3 * s + above + 1) >> 2
    up[1::2] = (3 * s + below + 2) >> 2
  else:
    up = np.repeat(np.repeat(s, fy, 0), fx, 1)
  return up[:height, :width]


def _ycc_to_rgb(y, cb, cr):
  """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c), clamped."""
  fix = lambda v: int(v * 65536 + 0.5)
  cb = cb - 128
  cr = cr - 128
  r = y + ((fix(1.40200) * cr + 32768) >> 16)
  b = y + ((fix(1.77200) * cb + 32768) >> 16)
  g = y + ((-fix(0.34414) * cb + 32768 - fix(0.71414) * cr) >> 16)
  return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _parse_sos(body, comps_by_id):
  ns = body[0]
  scomps, tables = [], []
  for i in range(ns):
    cid, t = body[1 + 2 * i], body[2 + 2 * i]
    scomps.append(comps_by_id[cid])
    tables.append((t >> 4, t & 15))
  ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
  return scomps, tables, ss, se, a >> 4, a & 15


def decode_jpeg(data: bytes) -> np.ndarray:
  """The uint8 array of a JPEG file: [H, W] grey or [H, W, 3] RGB."""
  if data[:2] != b'\xff\xd8':
    raise ValueError('not a JPEG file.')
  qt, dc_t, ac_t = {}, {}, {}
  frame, restart, adobe, jfif = None, 0, None, False
  comps_by_id = {}
  pos = 2
  while pos < len(data):
    if data[pos] != 0xFF:
      raise ValueError(f'corrupt JPEG: no marker at byte {pos}.')
    marker = data[pos + 1]
    if marker == 0xFF:  # Fill byte.
      pos += 1
      continue
    pos += 2
    if marker == 0xD9:  # EOI
      break
    if 0xD0 <= marker <= 0xD7 or marker == 0x01:
      continue
    length, = struct.unpack('>H', data[pos:pos + 2])
    body = data[pos + 2:pos + length]
    pos += length
    if marker == 0xDB:  # DQT
      i = 0
      while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        n = 128 if pq else 64
        vals = np.frombuffer(body[i + 1:i + 1 + n], '>u2' if pq else np.uint8)
        table = np.empty(64, np.int64)
        table[ZIGZAG] = vals
        qt[tq] = table
        i += 1 + n
    elif marker == 0xC4:  # DHT
      i = 0
      while i < len(body):
        tc, th = body[i] >> 4, body[i] & 15
        bits = list(body[i + 1:i + 17])
        vals = list(body[i + 17:i + 17 + sum(bits)])
        (ac_t if tc else dc_t)[th] = (bits, vals)
        i += 17 + sum(bits)
    elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1/2: Huffman, 8 bit.
      precision, height, width, nc = struct.unpack('>BHHB', body[:6])
      if precision != 8:
        raise NotImplementedError(
            f'{precision}-bit JPEG: only 8-bit samples are decoded.')
      if height == 0:
        raise NotImplementedError('JPEG with its height in a DNL marker.')
      if nc not in (1, 3):
        raise NotImplementedError(f'JPEG with {nc} components: grayscale '
                                  'and YCbCr (or RGB) are decoded.')
      comps = []
      for i in range(nc):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        comps.append(_Component(cid, hv >> 4, hv & 15, tq))
      comps_by_id = {c.id: c for c in comps}
      frame = _Frame(height, width, comps, marker == 0xC2)
    elif marker in _SOF_UNSUPPORTED or marker == 0xCC:
      what = _SOF_UNSUPPORTED.get(marker, 'arithmetic-coded (DAC)')
      raise NotImplementedError(f'{what} JPEG: only Huffman-coded baseline '
                                'and progressive JPEGs are decoded.')
    elif marker == 0xDD:  # DRI
      restart, = struct.unpack('>H', body[:2])
    elif marker == 0xE0 and body[:5] == b'JFIF\x00':
      jfif = True
    elif marker == 0xEE and body[:5] == b'Adobe':
      adobe = body[11] if len(body) > 11 else None
    elif marker == 0xDA:  # SOS
      if frame is None:
        raise ValueError('corrupt JPEG: a scan before the frame header.')
      scomps, tables, ss, se, ah, al = _parse_sos(body, comps_by_id)
      for c in scomps:
        if c.quant is None:
          c.quant = qt[c.tq]
      units, per_mcu = _units(frame, scomps)
      intervals, pos = _intervals(data, pos, restart)
      coef_lists = [c.coefs for c in scomps]
      if not frame.progressive:
        _decode_baseline(
            units, per_mcu, intervals, restart, coef_lists,
            [_fast_table(*dc_t[d], False) for d, _ in tables],
            [_fast_table(*ac_t[a], True) for _, a in tables])
      else:
        _decode_progressive(
            units, per_mcu, intervals, restart, coef_lists,
            [_symbol_table(*dc_t[d]) if ss == 0 and ah == 0 else None
             for d, _ in tables],
            [_symbol_table(*ac_t[a]) if ss else None for _, a in tables],
            ss, se, ah, al)
  if frame is None:
    raise ValueError('corrupt JPEG: no frame.')
  planes = [_plane(c) for c in frame.comps]
  if len(planes) == 1:
    return planes[0].astype(np.uint8)
  full = [
      _upsample(p, frame.vmax // c.v, frame.hmax // c.h, frame.height,
                frame.width) for p, c in zip(planes, frame.comps)]
  ids = tuple(c.id for c in frame.comps)
  # libjpeg's guess of the color space (jdapimin.c default_decompress_parms).
  rgb = (not jfif and (adobe == 0 or (adobe is None and ids == (82, 71, 66))))
  if rgb:
    return np.stack(full, -1).astype(np.uint8)
  return _ycc_to_rgb(*full)


# --- Encoding. -------------------------------------------------------------

# The quantization tables of JPEG Annex K.1, natural order.
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_QUANT = np.full(64, 99)
STD_CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]

# The Huffman tables of JPEG Annex K.3: (BITS, HUFFVAL).
STD_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
               tuple(range(12)))
STD_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                 tuple(range(12)))
STD_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
               bytes.fromhex(
                   '01020300041105122131410613516107227114328191a1082342b1c1'
                   '1552d1f02433627282090a161718191a25262728292a343536373839'
                   '3a434445464748494a535455565758595a636465666768696a737475'
                   '767778797a838485868788898a92939495969798999aa2a3a4a5a6a7'
                   'a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8'
                   'd9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa'))
STD_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                 bytes.fromhex(
                     '000102031104052131061241510761711322328108144291a1b1'
                     'c109233352f0156272d10a162434e125f11718191a262728292a'
                     '35363738393a434445464748494a535455565758595a63646566'
                     '6768696a737475767778797a82838485868788898a9293949596'
                     '9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5'
                     'c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4'
                     'f5f6f7f8f9fa'))


def quality_tables(quality):
  """The luma and chroma tables (natural order) of IJG quality `quality`
  (jcparam.c jpeg_set_quality, baseline: values capped at 255)."""
  quality = min(max(int(quality), 1), 100)
  scale = 5000 // quality if quality < 50 else 200 - 2 * quality
  return tuple(np.clip((t * scale + 50) // 100, 1, 255)
               for t in (STD_LUMA_QUANT, STD_CHROMA_QUANT))


def _encode_table(spec):
  """(code, length) per symbol of a (BITS, HUFFVAL) table, as arrays."""
  code = np.zeros(256, np.int64)
  length = np.zeros(256, np.int64)
  for c, n, s in _canonical_codes(*spec):
    code[s], length[s] = c, n
  return code, length


def _rgb_to_ycc(rgb):
  """libjpeg's fixed-point RGB -> YCbCr (jccolor.c), int64 planes."""
  fix = lambda v: int(v * 65536 + 0.5)
  r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
  y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + 32768) >> 16
  off = (128 << 16) + 32767
  cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off) >> 16
  cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off) >> 16
  return y, cb, cr


def _pad(plane, rows, cols):
  """Edge replication to [rows, cols], as libjpeg pads its inputs."""
  return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])),
                mode='edge')


def _downsample_h2v2(plane):
  """libjpeg's h2v2_downsample: 2x2 sums with the bias 1, 2, 1, 2, ..."""
  s = (plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] +
       plane[1::2, 1::2])
  bias = np.tile([1, 2], s.shape[1] // 2 + 1)[:s.shape[1]]
  return (s + bias) >> 2


def quantize(coefs, quant):
  """libjpeg-turbo's quantizer (jcdctmgr.c): the DCT's output divided by
  8 x quant through the reciprocals of compute_reciprocal, rounded half
  away from zero."""
  div = (quant * 8).astype(np.int64)
  b = np.floor(np.log2(div)).astype(np.int64)
  r = 16 + b
  fq = (np.int64(1) << r) // div
  fr = (np.int64(1) << r) % div
  c = div // 2
  pow2 = fr == 0
  fq = np.where(pow2, fq >> 1, fq)
  r = np.where(pow2, r - 1, r)
  c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
  fq = np.where(~pow2 & (fr > div // 2), fq + 1, fq)
  a = np.abs(coefs)
  q = ((a + c) * fq) >> r
  return np.where(coefs < 0, -q, q)


def _blocks(plane):
  """[rows, cols] (multiples of 8) -> [rows/8 * cols/8, 8, 8], raster."""
  h, w = plane.shape
  return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(
      -1, 8, 8)


_POW2 = 1 << np.arange(16)


def _bit_size(a):
  """JPEG's magnitude category of |values|: 0 for 0, else bit length."""
  return np.searchsorted(_POW2, np.abs(a), side='right')


def _entropy_code(zz, comp_of_block, dc_tabs, ac_tabs):
  """The Huffman-coded scan of blocks zz [B, 64] (zigzag, scan order)."""
  nb = zz.shape[0]
  dc = zz[:, 0]
  diff = np.empty(nb, np.int64)
  for c in np.unique(comp_of_block):
    sel = np.nonzero(comp_of_block == c)[0]
    diff[sel] = np.diff(dc[sel], prepend=0)
  # Items: (sort key, code, code length, value bits, value size).
  keys, codes, lens, vals, sizes = [], [], [], [], []

  def add(key, comp_tables, sym, value, size):
    code, length = comp_tables
    keys.append(key)
    codes.append(code[sym])
    lens.append(length[sym])
    vals.append(np.where(value < 0, value + (1 << size) - 1, value) &
                ((1 << size) - 1))
    sizes.append(size)

  block = np.arange(nb)
  dsize = _bit_size(diff)
  for c, tabs in dc_tabs.items():
    sel = comp_of_block == c
    add(block[sel] * 1024, tabs, dsize[sel], diff[sel], dsize[sel])
  b, k = np.nonzero(zz[:, 1:])
  k = k + 1
  v = zz[b, k]
  first = np.ones(len(b), bool)
  first[1:] = b[1:] != b[:-1]
  prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
  run = k - prev - 1
  size = _bit_size(v)
  comp = comp_of_block[b]
  for c, tabs in ac_tabs.items():
    sel = comp == c
    bs, ks, rs = b[sel], k[sel], run[sel]
    for j in range(3):  # Runs of 16 zeros (ZRL) before the coefficient.
      z = rs >= 16 * (j + 1)
      zeros = np.zeros(int(z.sum()), np.int64)
      add(bs[z] * 1024 + ks[z] * 8 + j, tabs, zeros + 0xF0, zeros, zeros)
    add(bs * 1024 + ks * 8 + 3, tabs, (rs % 16) * 16 + size[sel], v[sel],
        size[sel])
  # End of block after the last nonzero coefficient, where it is not 63.
  last = np.zeros(nb, np.int64)
  np.maximum.at(last, b, k)
  eob = last < 63
  for c, tabs in ac_tabs.items():
    sel = eob & (comp_of_block == c)
    zeros = np.zeros(int(sel.sum()), np.int64)
    add(block[sel] * 1024 + 1023, tabs, zeros, zeros, zeros)
  order = np.argsort(np.concatenate(keys), kind='stable')
  code = np.concatenate(codes)[order]
  length = np.concatenate(lens)[order]
  value = np.concatenate(vals)[order]
  size = np.concatenate(sizes)[order]
  word = (code << size) | value
  nbits = length + size
  # Every bit of every item, most significant first, then 1s to a byte.
  total = int(nbits.sum())
  owner = np.repeat(np.arange(len(word)), nbits)
  start = np.cumsum(nbits) - nbits
  shift = nbits[owner] - 1 - (np.arange(total) - start[owner])
  bits = ((word[owner] >> shift) & 1).astype(np.uint8)
  bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
  out = np.packbits(bits)
  ff = np.nonzero(out == 0xFF)[0]
  return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker, body):
  return struct.pack('>BBH', 0xFF, marker, len(body) + 2) + body


def encode_jpeg(img_u8: np.ndarray, quality: int = 90,
                exif: bytes | None = None, subsampling: str = '4:2:0') -> bytes:
  """A baseline JPEG of an [H, W] (grey) or [H, W, 3] (RGB) uint8 array:
  YCbCr with `subsampling` '4:2:0' (Pillow's default) or '4:4:4' (its
  ``subsampling=0``) at IJG quality `quality`, standard Huffman tables;
  `exif`, a TIFF block, goes into an APP1 Exif segment."""
  img = np.asarray(img_u8)
  if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
      img.ndim == 3 and img.shape[-1] != 3):
    raise ValueError(f'cannot encode a {img.dtype} array of shape '
                     f'{img.shape} as JPEG.')
  height, width = img.shape[:2]
  if not (0 < height < 65536 and 0 < width < 65536):
    raise ValueError(f'cannot encode a {width} x {height} JPEG.')
  if subsampling not in ('4:2:0', '4:4:4'):
    raise ValueError(f'subsampling {subsampling!r}: 4:2:0 or 4:4:4.')
  luma_q, chroma_q = quality_tables(quality)
  grey = img.ndim == 2
  if grey:
    comps = [(img.astype(np.int64), 1, luma_q, 0)]
    mcu = 8
  elif subsampling == '4:4:4':
    y, cb, cr = _rgb_to_ycc(img)
    comps = [(y, 1, luma_q, 0), (cb, 1, chroma_q, 1), (cr, 1, chroma_q, 1)]
    mcu = 8
  else:
    y, cb, cr = _rgb_to_ycc(img)
    mcu = 16
    even = lambda p: _pad(p, height + height % 2, -(-width // mcu) * mcu)
    comps = [(y, 2, luma_q, 0)] + [
        (_downsample_h2v2(even(p)), 1, chroma_q, 1) for p in (cb, cr)]
  mcuy, mcux = -(-height // mcu), -(-width // mcu)
  zz_all, comp_ids = [], []
  for ci, (plane, f, quant, _) in enumerate(comps):
    plane = _pad(plane, mcuy * 8 * f, mcux * 8 * f)
    coefs = fdct_islow(_blocks(plane) - 128)
    q = quantize(coefs.reshape(-1, 64), quant)[:, ZIGZAG]
    # Scan order: per MCU, the component's f x f blocks row by row.
    q = q.reshape(mcuy, f, mcux, f, 64).transpose(0, 2, 1, 3, 4)
    zz_all.append(q.reshape(mcuy * mcux, f * f, 64))
    comp_ids.append(np.full((mcuy * mcux, f * f), ci))
  zz = np.concatenate(zz_all, 1).reshape(-1, 64)
  comp_of_block = np.concatenate(comp_ids, 1).reshape(-1)
  luma = (_encode_table(STD_DC_LUMA), _encode_table(STD_AC_LUMA))
  chroma = (_encode_table(STD_DC_CHROMA), _encode_table(STD_AC_CHROMA))
  tabs = [luma if table == 0 else chroma for _, _, _, table in comps]
  scan = _entropy_code(zz, comp_of_block,
                       {c: t[0] for c, t in enumerate(tabs)},
                       {c: t[1] for c, t in enumerate(tabs)})
  out = [b'\xff\xd8', _segment(0xE0, b'JFIF\x00\x01\x01\x00' +
                                 struct.pack('>HHBB', 1, 1, 0, 0))]
  if exif is not None:
    out.append(_segment(0xE1, b'Exif\x00\x00' + exif))
  for i, quant in enumerate((luma_q,) if grey else (luma_q, chroma_q)):
    out.append(_segment(0xDB, bytes([i]) + bytes(
        quant[ZIGZAG].astype(np.uint8))))
  sof = struct.pack('>BHHB', 8, height, width, len(comps))
  for ci, (_, f, _, table) in enumerate(comps):
    sof += bytes([ci + 1, f * 16 + f, table])
  out.append(_segment(0xC0, sof))
  specs = [(0x00, STD_DC_LUMA), (0x10, STD_AC_LUMA)]
  if not grey:
    specs += [(0x01, STD_DC_CHROMA), (0x11, STD_AC_CHROMA)]
  for tc_th, (bits, vals) in specs:
    out.append(_segment(0xC4, bytes([tc_th]) + bytes(bits) + bytes(vals)))
  sos = bytes([len(comps)])
  for ci, (_, _, _, table) in enumerate(comps):
    sos += bytes([ci + 1, table * 16 + table])
  out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
  out.append(scan)
  out.append(b'\xff\xd9')
  return b''.join(out)
