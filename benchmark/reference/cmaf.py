"""Checks of a packaged HEVC CMAF tree, written from the formats' own
definitions (ISO/IEC 14496-12 boxes, 14496-15 ``hvcC`` and its codec
string, H.265 NAL unit headers, HLS playlists) and importing nothing of
the program.

How far it reaches into the coded bytes: every sample is split into its
length-prefixed NAL units, whose lengths must tile the sample exactly,
whose headers must be well formed, with IDR slices exactly on the sync
samples and trailing slices elsewhere, and whose first slice must open
its picture. The CABAC payload inside a slice is not decoded (the repo
has no HEVC decoder).
"""

from __future__ import annotations

import hashlib
import json
import re
import struct
from pathlib import Path

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"mvex", b"moof",
              b"traf", b"dinf", b"edts"}
NON_SYNC = 0x00010000
IDR_TYPES = {19, 20}
TRAIL_TYPES = {0, 1}
PARAM_TYPES = set(range(32, 41))


def boxes(data: bytes, start: int = 0, end: int | None = None):
    """(type, payload start, box end) of each box in data[start:end]."""
    end = len(data) if end is None else end
    at = start
    while at < end:
        if at + 8 > end:
            raise ValueError(f"truncated box header at {at}")
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        head = 8
        if size == 1:
            size = struct.unpack(">Q", data[at + 8:at + 16])[0]
            head = 16
        if size < head or at + size > end:
            raise ValueError(f"box {kind!r} at {at} overruns ({size})")
        yield kind, at + head, at + size
        at += size


def find(data: bytes, path: list[bytes], start: int = 0,
         end: int | None = None):
    """Every (payload start, end) at the box path below data[start:end]."""
    out = []
    for kind, a, b in boxes(data, start, end):
        if kind != path[0]:
            continue
        if len(path) == 1:
            out.append((a, b))
        else:
            out.extend(find(data, path[1:], a, b))
    return out


def hvcc_codec_string(hvcc: bytes) -> str:
    """The RFC 6381 string of an ``hvcC`` record (14496-15 Annex E)."""
    b1 = hvcc[1]
    space, tier, idc = b1 >> 6, (b1 >> 5) & 1, b1 & 0x1F
    compat = struct.unpack(">I", hvcc[2:6])[0]
    rev = int(f"{compat:032b}"[::-1], 2)
    cons = list(hvcc[6:12])
    while cons and cons[-1] == 0:
        cons.pop()
    level = hvcc[12]
    s = f"hvc1.{'' if space == 0 else 'ABC'[space - 1]}{idc}.{rev:X}." \
        f"{'H' if tier else 'L'}{level}"
    return s + "".join(f".{c:X}" for c in cons)


def read_init(path: Path) -> dict:
    """Width, height, timescale, NAL length size, codec string and trex
    defaults of an HEVC init segment."""
    data = path.read_bytes()
    (stsd,) = find(data, [b"moov", b"trak", b"mdia", b"minf", b"stbl",
                          b"stsd"])
    entries = list(boxes(data, stsd[0] + 8, stsd[1]))
    if len(entries) != 1 or entries[0][0] != b"hvc1":
        raise ValueError(f"{path}: sample entries {[e[0] for e in entries]}")
    _, a, b = entries[0]
    width, height = struct.unpack(">HH", data[a + 24:a + 28])
    (hvcc,) = find(data, [b"hvcC"], a + 78, b)
    rec = data[hvcc[0]:hvcc[1]]
    (mdhd,) = find(data, [b"moov", b"trak", b"mdia", b"mdhd"])
    ver = data[mdhd[0]]
    ts = struct.unpack(">I", data[mdhd[0] + (20 if ver == 1 else 12):][:4])[0]
    trex = find(data, [b"moov", b"mvex", b"trex"])
    dflt = {"duration": None, "size": None, "flags": 0}
    if trex:
        _, _, dur, size, flags = struct.unpack(
            ">IIIII", data[trex[0][0] + 4:trex[0][0] + 24])
        dflt = {"duration": dur, "size": size, "flags": flags}
    return {"width": width, "height": height, "timescale": ts,
            "nal_len": (rec[21] & 3) + 1, "codec": hvcc_codec_string(rec),
            "trex": dflt}


def read_segment(path: Path, init: dict) -> list[dict]:
    """The samples of one media segment: size, duration, sync, bytes."""
    data = path.read_bytes()
    top = list(boxes(data))
    kinds = [k for k, _, _ in top]
    if kinds.count(b"moof") != 1 or kinds.count(b"mdat") != 1:
        raise ValueError(f"{path}: top-level boxes {kinds}")
    moof = next((a - 8, b) for k, a, b in top if k == b"moof")
    mdat = next((a, b) for k, a, b in top if k == b"mdat")
    (tfhd,) = find(data, [b"traf", b"tfhd"], moof[0] + 8, moof[1])
    tf_flags = int.from_bytes(data[tfhd[0] + 1:tfhd[0] + 4], "big")
    at = tfhd[0] + 8
    base = moof[0]
    if tf_flags & 0x1:
        base = struct.unpack(">Q", data[at:at + 8])[0]
        at += 8
    dflt = dict(init["trex"])
    if tf_flags & 0x2:
        at += 4
    for bit, key in ((0x8, "duration"), (0x10, "size"), (0x20, "flags")):
        if tf_flags & bit:
            dflt[key] = struct.unpack(">I", data[at:at + 4])[0]
            at += 4
    (trun,) = find(data, [b"traf", b"trun"], moof[0] + 8, moof[1])
    fl = int.from_bytes(data[trun[0] + 1:trun[0] + 4], "big")
    count = struct.unpack(">I", data[trun[0] + 4:trun[0] + 8])[0]
    at = trun[0] + 8
    offset = 0
    if fl & 0x1:
        offset = struct.unpack(">i", data[at:at + 4])[0]
        at += 4
    first_flags = None
    if fl & 0x4:
        first_flags = struct.unpack(">I", data[at:at + 4])[0]
        at += 4
    samples = []
    pos = base + offset
    for i in range(count):
        rec = {}
        for bit, key in ((0x100, "duration"), (0x200, "size"),
                         (0x400, "flags"), (0x800, "cto")):
            if fl & bit:
                rec[key] = struct.unpack(">I", data[at:at + 4])[0]
                at += 4
        dur = rec.get("duration", dflt["duration"])
        size = rec.get("size", dflt["size"])
        flags = rec.get("flags", first_flags if i == 0 and first_flags
                        is not None else dflt["flags"])
        samples.append({"duration": dur, "size": size,
                        "sync": not flags & NON_SYNC,
                        "bytes": data[pos:pos + size]})
        pos += size
    if base + offset != mdat[0] or pos != mdat[1]:
        raise ValueError(f"{path}: samples span {base + offset}..{pos}, "
                         f"mdat {mdat[0]}..{mdat[1]}")
    return samples


def nal_faults(sample: bytes, nal_len: int, sync: bool) -> list[str]:
    """What is wrong with one sample's NAL units (empty: nothing)."""
    out, at, vcl = [], 0, []
    while at < len(sample):
        if at + nal_len > len(sample):
            return ["NAL length prefix overruns the sample"]
        n = int.from_bytes(sample[at:at + nal_len], "big")
        at += nal_len
        if n < 3 or at + n > len(sample):
            return [f"NAL of {n} bytes overruns the sample"]
        h0, h1 = sample[at], sample[at + 1]
        kind, layer, tid = (h0 >> 1) & 0x3F, ((h0 & 1) << 5) | (h1 >> 3), h1 & 7
        if h0 & 0x80 or layer or not tid:
            out.append(f"bad NAL header {h0:02x}{h1:02x}")
        if kind in IDR_TYPES | TRAIL_TYPES:
            vcl.append((kind, sample[at + 2] >> 7))
        elif kind not in PARAM_TYPES:
            out.append(f"unexpected NAL type {kind}")
        at += n
    if not vcl:
        return out + ["no slice in the sample"]
    want = IDR_TYPES if sync else TRAIL_TYPES
    if any(k not in want for k, _ in vcl):
        out.append(f"slice types {[k for k, _ in vcl]} in a "
                   f"{'sync' if sync else 'non-sync'} sample")
    if vcl[0][1] != 1:
        out.append("first slice does not open its picture")
    return out


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        for chunk in iter(lambda: fp.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def manifest_faults(root: Path) -> list[str]:
    """``outputs.json`` lists every published file with its size and
    SHA-256, and nothing else."""
    try:
        man = json.loads((root / "outputs.json").read_text())
        files = man["files"]
    except (OSError, ValueError, KeyError, TypeError) as exc:
        return [f"outputs.json unreadable: {exc}"]
    out = []
    on_disk = {str(p.relative_to(root)) for p in root.rglob("*")
               if p.is_file()} - {"outputs.json", "rc_journal.jsonl"}
    on_disk = {f for f in on_disk if not f.endswith((".tmp", ".part"))}
    if set(files) != on_disk:
        out.append(f"outputs.json lists {sorted(set(files) ^ on_disk)[:5]} "
                   "apart from the tree")
    for rel, meta in sorted(files.items()):
        p = root / rel
        if not p.is_file():
            continue
        if p.stat().st_size != meta.get("size") \
                or _sha256(p) != meta.get("sha256"):
            out.append(f"{rel}: size or sha256 differs from outputs.json")
    return out


_STREAM = re.compile(r"#EXT-X-STREAM-INF:(.*)")
_CODECS = re.compile(r'CODECS="([^"]*)"')


def tree_faults(root: Path, rungs: list[dict], frames: int, fps: int,
                gop: int) -> list[str]:
    """Every fault of one job's tree. ``rungs``: the expected rungs, each
    {"name", "height", "width"}; ``frames`` source frames at ``fps``,
    IDRs every ``gop`` frames."""
    out: list[str] = []
    codecs: dict[str, str] = {}
    for r in rungs:
        rdir = root / r["name"]
        try:
            init = read_init(rdir / "init.mp4")
        except (OSError, ValueError) as exc:
            out.append(f"{r['name']}/init.mp4: {exc}")
            continue
        codecs[r["name"]] = init["codec"]
        if (init["width"], init["height"]) != (r["width"], r["height"]):
            out.append(f"{r['name']}: sample entry {init['width']}x"
                       f"{init['height']}")
        segs = sorted(rdir.glob("segment_*.m4s"))
        samples = []
        for s in segs:
            try:
                samples += read_segment(s, init)
            except (OSError, ValueError, struct.error) as exc:
                out.append(f"{r['name']}/{s.name}: {exc}")
        if len(samples) != frames:
            out.append(f"{r['name']}: {len(samples)} samples, want {frames}")
        want_dur = init["timescale"] // fps
        if any(s["duration"] != want_dur for s in samples):
            out.append(f"{r['name']}: sample durations differ from "
                       f"{want_dur}/{init['timescale']}")
        for i, s in enumerate(samples):
            if s["sync"] != (i % gop == 0):
                out.append(f"{r['name']}: sample {i} sync flag {s['sync']}")
                break
            bad = nal_faults(s["bytes"], init["nal_len"], s["sync"])
            if bad:
                out.append(f"{r['name']}: sample {i}: {bad[0]}")
                break
        out += _playlist_faults(rdir, segs, frames / fps)
    try:
        master = (root / "master.m3u8").read_text()
    except OSError as exc:
        return out + [f"master.m3u8: {exc}"]
    lines = master.splitlines()
    seen = {}
    for i, ln in enumerate(lines):
        m = _STREAM.match(ln)
        if m and i + 1 < len(lines):
            c = _CODECS.search(m.group(1))
            seen[lines[i + 1].split("/")[0]] = c.group(1) if c else None
    for name, codec in codecs.items():
        got = (seen.get(name) or "").split(",")
        if codec not in got:
            out.append(f"master.m3u8: {name} codecs {got}, want {codec}")
    if set(seen) != {r["name"] for r in rungs}:
        out.append(f"master.m3u8 variants {sorted(seen)}")
    return out + manifest_faults(root)


def _playlist_faults(rdir: Path, segs: list[Path], seconds: float) -> list[str]:
    lists = [p for p in rdir.glob("*.m3u8")]
    if len(lists) != 1:
        return [f"{rdir.name}: {len(lists)} media playlists"]
    text = lists[0].read_text()
    durs = [float(x) for x in re.findall(r"#EXTINF:([0-9.]+)", text)]
    uris = [ln for ln in text.splitlines() if ln.endswith(".m4s")]
    out = []
    if uris != [s.name for s in segs]:
        out.append(f"{rdir.name}: playlist segments {uris[:3]}")
    if abs(sum(durs) - seconds) > 1e-3:
        out.append(f"{rdir.name}: playlist lasts {sum(durs)} s, want {seconds}")
    return out
