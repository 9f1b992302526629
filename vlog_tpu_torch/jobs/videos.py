"""Video-row lifecycle helpers shared by the admin API and workers (a copy of
``vlog_tpu/jobs/videos.py``).

Reference parity: admin.py:1746-1832 (insert + enqueue on upload) and
transcoder.py:2772-2867 (finalize: video_qualities rows, status=ready,
downstream job enqueue). These are the only places video.status moves,
so both the HTTP plane and the in-process worker use one vocabulary.
"""

from __future__ import annotations

import json
import re
import unicodedata
from typing import Any

from vlog_tpu_torch.db.core import Database, Row, now as db_now
from vlog_tpu_torch.enums import VideoStatus

_SLUG_RE = re.compile(r"[^a-z0-9]+")


def slugify(title: str, max_len: int = 80) -> str:
    """ASCII slug from a title (admin.py slug generation analog)."""
    norm = unicodedata.normalize("NFKD", title)
    ascii_str = norm.encode("ascii", "ignore").decode("ascii").lower()
    slug = _SLUG_RE.sub("-", ascii_str).strip("-")
    return slug[:max_len] or "video"


async def unique_slug(db: Database, title: str) -> str:
    base = slugify(title)
    slug = base
    n = 1
    while await db.fetch_one("SELECT 1 FROM videos WHERE slug=:s", {"s": slug}):
        n += 1
        slug = f"{base}-{n}"
    return slug


async def create_video(
    db: Database,
    title: str,
    *,
    source_path: str | None = None,
    original_filename: str | None = None,
    size_bytes: int | None = None,
    description: str = "",
    category: str | None = None,
    tags: list[str] | None = None,
) -> Row:
    slug = await unique_slug(db, title)
    t = db_now()
    vid = await db.execute(
        """
        INSERT INTO videos (slug, title, description, original_filename,
                            source_path, size_bytes, category, tags,
                            created_at, updated_at)
        VALUES (:slug, :title, :d, :of, :sp, :sz, :cat, :tags, :t, :t)
        """,
        {
            "slug": slug, "title": title, "d": description,
            "of": original_filename, "sp": source_path, "sz": size_bytes,
            "cat": category, "tags": json.dumps(tags or []), "t": t,
        },
    )
    row = await db.fetch_one("SELECT * FROM videos WHERE id=:id", {"id": vid})
    assert row is not None
    return row


async def get_video(db: Database, video_id: int) -> Row | None:
    return await db.fetch_one("SELECT * FROM videos WHERE id=:id", {"id": video_id})


async def get_video_by_slug(db: Database, slug: str) -> Row | None:
    return await db.fetch_one("SELECT * FROM videos WHERE slug=:s", {"s": slug})


async def get_video_serving_state(db: Database, slug: str) -> Row | None:
    """The narrow row the delivery plane's publish-state cache fills
    from: id/slug/status/deleted_at only. The per-segment path must not
    drag the full tag/description payload out of the DB per miss."""
    return await db.fetch_one(
        "SELECT id, slug, status, deleted_at FROM videos WHERE slug=:s",
        {"s": slug})


async def invalidate_delivery(db: Database, video_id: int, *,
                              prewarm: bool = False) -> None:
    """Evict a video from in-process delivery-plane caches after a
    publish-visible mutation. The port serves no media (it has no
    delivery plane), so this returns at once, as the JAX package's does
    in a process with no delivery planes (a worker). The signature stays
    so the job plane's callers are the reference's."""
    return None


async def set_status(
    db: Database, video_id: int, status: VideoStatus, *, error: str | None = None
) -> None:
    await db.execute(
        "UPDATE videos SET status=:s, error=:e, updated_at=:t WHERE id=:id",
        {"s": status.value, "e": error, "t": db_now(), "id": video_id},
    )
    await invalidate_delivery(db, video_id)


async def finalize_ready(
    db: Database,
    video_id: int,
    *,
    probe: Any,                      # media.probe.VideoInfo
    qualities: list[dict],
    thumbnail_path: str | None,
    streaming_format: str | None = None,
    codec: str | None = None,
) -> None:
    """Publish the transcode result (reference transcoder.py:2772-2867).

    ``streaming_format``/``codec`` flip atomically WITH status=ready (the
    reencode path: the row must never say ready in one format while the
    tree holds another)."""
    t = db_now()
    async with db.transaction() as tx:
        await tx.execute(
            """
            UPDATE videos SET status='ready', error=NULL, duration_s=:dur,
                   width=:w, height=:h, fps=:fps, thumbnail_path=:thumb,
                   streaming_format=COALESCE(:fmt, streaming_format),
                   codec=COALESCE(:codec, codec),
                   updated_at=:t
            WHERE id=:id
            """,
            {
                "dur": probe.duration_s, "w": probe.width, "h": probe.height,
                "fps": probe.fps, "thumb": thumbnail_path, "t": t,
                "fmt": streaming_format, "codec": codec,
                "id": video_id,
            },
        )
        await tx.execute(
            "DELETE FROM video_qualities WHERE video_id=:v", {"v": video_id}
        )
        for q in qualities:
            await tx.execute(
                """
                INSERT INTO video_qualities (video_id, name, width, height,
                        video_bitrate, audio_bitrate, codec, playlist_path,
                        created_at)
                VALUES (:v, :n, :w, :h, :vb, :ab, :c, :pp, :t)
                """,
                {
                    "v": video_id, "n": q["quality"], "w": q["width"],
                    "h": q["height"], "vb": q.get("bitrate"),
                    "ab": q.get("audio_bitrate"),
                    "c": q.get("codec", "h264"),
                    "pp": q.get("playlist_path"), "t": t,
                },
            )
    # publish-keyed invalidation: a (re)published tree must be visible
    # to in-process delivery caches immediately, not after the TTL —
    # and the fresh tree's leading segments are prewarmed right behind
    await invalidate_delivery(db, video_id, prewarm=True)
