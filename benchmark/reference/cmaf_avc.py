"""Checks of a packaged H.264 CMAF tree, written from the formats' own
definitions (ISO/IEC 14496-12 boxes, 14496-15 ``avcC`` and its codec
string, H.264 NAL unit headers, HLS playlists) and importing nothing of
the program. The box, segment, playlist and ``outputs.json`` readers are
the HEVC checks' (``reference/cmaf.py``); what is H.264's own is here.

How far it reaches into the coded bytes: ``avcC`` must hold one or more
sequence and picture parameter sets whose headers are well formed, its
profile and level bytes must be the first SPS's, and the codec string
``master.m3u8`` announces must be the one they give. Every sample is
split into its length-prefixed NAL units, whose lengths must tile the
sample exactly, whose headers must be well formed, with IDR slices
exactly on the sync samples and non-IDR slices elsewhere, and whose
first slice must open its picture (``first_mb_in_slice`` 0). The CABAC
payload inside a slice is not decoded.
"""

from __future__ import annotations

import struct
from pathlib import Path

from benchmark.reference.cmaf import (_CODECS, _STREAM, _playlist_faults,
                                      boxes, find, manifest_faults,
                                      read_segment)

IDR, NON_IDR, SEI, SPS, PPS, AUD = 5, 1, 6, 7, 8, 9


def avcc_record(rec: bytes) -> dict:
    """The fields of an AVCDecoderConfigurationRecord (14496-15 5.3.3.1);
    raises ValueError where it is malformed."""
    if len(rec) < 7 or rec[0] != 1:
        raise ValueError("avcC: configurationVersion is not 1")
    at = 5
    sets = {}
    for kind, mask in ((SPS, 0x1F), (PPS, 0xFF)):
        count = rec[at] & mask
        at += 1
        sets[kind] = []
        for _ in range(count):
            n = struct.unpack(">H", rec[at:at + 2])[0]
            at += 2
            if n < 2 or at + n > len(rec):
                raise ValueError(f"avcC: parameter set of {n} bytes overruns")
            sets[kind].append(rec[at:at + n])
            at += n
    if at != len(rec):
        raise ValueError(f"avcC: {len(rec) - at} bytes after the PPS")
    return {"profile": rec[1:4], "nal_len": (rec[4] & 3) + 1,
            "sps": sets[SPS], "pps": sets[PPS]}


def avcc_codec_string(rec: bytes) -> str:
    """The RFC 6381 string of an ``avcC`` record: ``avc1.PPCCLL``
    (profile, constraint flags, level; 14496-15 Annex E)."""
    return "avc1." + "".join(f"{b:02X}" for b in rec[1:4])


def avcc_faults(avcc: dict) -> list[str]:
    out = []
    if not avcc["sps"] or not avcc["pps"]:
        out.append(f"avcC: {len(avcc['sps'])} SPS, {len(avcc['pps'])} PPS")
    for kind, nals in ((SPS, avcc["sps"]), (PPS, avcc["pps"])):
        for nal in nals:
            if nal[0] & 0x80 or nal[0] & 0x1F != kind or not nal[0] & 0x60:
                out.append(f"avcC: bad parameter set header {nal[0]:02x}")
    if avcc["sps"] and avcc["sps"][0][1:4] != avcc["profile"]:
        out.append("avcC: profile and level bytes differ from the SPS's")
    return out


def read_init(path: Path) -> dict:
    """Width, height, timescale, NAL length size, codec string, the
    ``avcC`` record's faults and trex defaults of an H.264 init
    segment."""
    data = path.read_bytes()
    (stsd,) = find(data, [b"moov", b"trak", b"mdia", b"minf", b"stbl",
                          b"stsd"])
    entries = list(boxes(data, stsd[0] + 8, stsd[1]))
    if len(entries) != 1 or entries[0][0] != b"avc1":
        raise ValueError(f"{path}: sample entries {[e[0] for e in entries]}")
    _, a, b = entries[0]
    width, height = struct.unpack(">HH", data[a + 24:a + 28])
    (avcc,) = find(data, [b"avcC"], a + 78, b)
    rec = data[avcc[0]:avcc[1]]
    fields = avcc_record(rec)
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
            "nal_len": fields["nal_len"], "codec": avcc_codec_string(rec),
            "avcc_faults": avcc_faults(fields), "trex": dflt}


def nal_faults(sample: bytes, nal_len: int, sync: bool) -> list[str]:
    """What is wrong with one sample's NAL units (empty: nothing)."""
    out, at, vcl = [], 0, []
    while at < len(sample):
        if at + nal_len > len(sample):
            return ["NAL length prefix overruns the sample"]
        n = int.from_bytes(sample[at:at + nal_len], "big")
        at += nal_len
        if n < 2 or at + n > len(sample):
            return [f"NAL of {n} bytes overruns the sample"]
        h0 = sample[at]
        kind, ref_idc = h0 & 0x1F, (h0 >> 5) & 3
        if h0 & 0x80:
            out.append(f"bad NAL header {h0:02x}")
        if kind in (IDR, NON_IDR):
            # first_mb_in_slice is ue(v): 0 is the single bit 1
            vcl.append((kind, ref_idc, sample[at + 1] >> 7))
        elif kind not in (SEI, SPS, PPS, AUD):
            out.append(f"unexpected NAL type {kind}")
        at += n
    if not vcl:
        return out + ["no slice in the sample"]
    want = IDR if sync else NON_IDR
    if any(k != want for k, _, _ in vcl):
        out.append(f"slice types {[k for k, _, _ in vcl]} in a "
                   f"{'sync' if sync else 'non-sync'} sample")
    if any(k == IDR and not ref for k, ref, _ in vcl):
        out.append("IDR slice with nal_ref_idc 0")
    if vcl[0][2] != 1:
        out.append("first slice does not open its picture")
    return out


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
        except (OSError, ValueError, struct.error) as exc:
            out.append(f"{r['name']}/init.mp4: {exc}")
            continue
        out += [f"{r['name']}: {f}" for f in init["avcc_faults"]]
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
