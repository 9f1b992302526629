"""Low-level ISO-BMFF (MP4) box reading and writing.

ISO/IEC 14496-12 box model: [size:u32][type:4cc][payload], with size==1
meaning a following u64 largesize and size==0 meaning "to end of file".
Container boxes hold child boxes as their payload.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator

# Boxes whose payload is a sequence of child boxes.
CONTAINER_TYPES = {
    "moov", "trak", "mdia", "minf", "stbl", "dinf", "edts",
    "mvex", "moof", "traf", "mfra", "udta", "meta_children",
}

# "Full boxes" start with version(u8) + flags(u24); kept for reference.
_FULL_BOXES = {
    "mvhd", "tkhd", "mdhd", "hdlr", "vmhd", "smhd", "dref", "url ",
    "stsd", "stts", "stss", "stsc", "stsz", "stco", "co64", "ctts",
    "trex", "mehd", "mfhd", "tfhd", "tfdt", "trun", "sidx", "elst",
}


@dataclass
class Box:
    type: str
    payload: bytes = b""                 # raw payload (leaf boxes)
    children: list["Box"] = field(default_factory=list)  # container boxes
    offset: int = 0                      # absolute file offset of the header
    size: int = 0                        # total box size incl. header

    def find(self, *path: str) -> "Box | None":
        """First descendant matching a path of types, e.g. find('trak','mdia')."""
        if not path:
            return self
        for child in self.children:
            if child.type == path[0]:
                found = child.find(*path[1:])
                if found is not None:
                    return found
        return None

    def find_all(self, box_type: str) -> list["Box"]:
        return [c for c in self.children if c.type == box_type]


def _read_box_header(fp: BinaryIO) -> tuple[str, int, int] | None:
    """Returns (type, total_size, header_size) or None at EOF."""
    start = fp.read(8)
    if len(start) < 8:
        return None
    size = struct.unpack(">I", start[:4])[0]
    btype = start[4:8].decode("latin-1")
    header = 8
    if size == 1:
        large = fp.read(8)
        if len(large) < 8:
            raise ValueError("truncated largesize box")
        size = struct.unpack(">Q", large)[0]
        header = 16
    elif size == 0:
        pos = fp.tell()
        fp.seek(0, 2)
        size = fp.tell() - pos + 8
        fp.seek(pos)
    if size < header:
        raise ValueError(f"invalid box size {size} for {btype!r}")
    return btype, size, header


def iter_boxes(fp: BinaryIO, end: int | None = None) -> Iterator[tuple[str, int, int, int]]:
    """Yield (type, payload_offset, payload_size, box_offset) without recursion."""
    while True:
        offset = fp.tell()
        if end is not None and offset >= end:
            return
        hdr = _read_box_header(fp)
        if hdr is None:
            return
        btype, size, hsize = hdr
        yield btype, offset + hsize, size - hsize, offset
        fp.seek(offset + size)


def parse_box_tree(fp: BinaryIO, *, end: int | None = None, max_depth: int = 12) -> list[Box]:
    """Parse boxes into a tree, descending into known container types.

    Leaf payloads are fully read into memory EXCEPT ``mdat`` (media data can
    be gigabytes) — its payload is left empty and located via offset/size.
    """
    result: list[Box] = []
    if end is None:
        pos = fp.tell()
        fp.seek(0, 2)
        end = fp.tell()
        fp.seek(pos)
    while fp.tell() < end:
        hdr = _read_box_header(fp)
        if hdr is None:
            break
        btype, size, hsize = hdr
        offset = fp.tell() - hsize
        payload_size = size - hsize
        box = Box(type=btype, offset=offset, size=size)
        if btype in CONTAINER_TYPES and max_depth > 0:
            box.children = parse_box_tree(
                fp, end=offset + size, max_depth=max_depth - 1
            )
        elif btype == "mdat":
            pass  # located by offset/size only
        else:
            box.payload = fp.read(payload_size)
        fp.seek(offset + size)
        result.append(box)
    return result


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------

def box(btype: str, *payloads: bytes) -> bytes:
    """Serialize one box; payloads are concatenated (children or raw bytes)."""
    body = b"".join(payloads)
    size = 8 + len(body)
    if size > 0xFFFFFFFF:
        return struct.pack(">I4sQ", 1, btype.encode("latin-1"), 16 + len(body)) + body
    return struct.pack(">I4s", size, btype.encode("latin-1")) + body


def full_box(btype: str, version: int, flags: int, *payloads: bytes) -> bytes:
    return box(btype, struct.pack(">B3s", version, flags.to_bytes(3, "big")), *payloads)


def u8(v: int) -> bytes:
    return struct.pack(">B", v)


def u16(v: int) -> bytes:
    return struct.pack(">H", v)


def u24(v: int) -> bytes:
    return v.to_bytes(3, "big")


def u32(v: int) -> bytes:
    return struct.pack(">I", v)


def u64(v: int) -> bytes:
    return struct.pack(">Q", v)


def s16(v: int) -> bytes:
    return struct.pack(">h", v)


def fixed16_16(v: float) -> bytes:
    return struct.pack(">i", int(round(v * 65536)))


def fixed8_8(v: float) -> bytes:
    return struct.pack(">h", int(round(v * 256)))


def fourcc(code: str) -> bytes:
    raw = code.encode("latin-1")
    if len(raw) != 4:
        raise ValueError(f"fourcc must be 4 bytes: {code!r}")
    return raw


IDENTITY_MATRIX = (
    u32(0x00010000) + u32(0) + u32(0)
    + u32(0) + u32(0x00010000) + u32(0)
    + u32(0) + u32(0) + u32(0x40000000)
)
