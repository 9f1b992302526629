"""The port's catalog routes (``vlog_tpu_torch/api/catalog.py``, mounted
by the admin app) against the JAX package's, and the one device step of
the admin plane: ``POST /api/videos/{id}/thumbnail/from-time``.

Each flow is sent in one sequence to both apps, each on its own copy of
``tests/test_torch_admin_api.py``'s site; the answers, the rows of every
table and the trees are held equal (timestamps, tokens and site paths
masked): playlists, custom fields, transcripts, bulk operations, the
thumbnail upload and reads, sprites.

The thumbnail grab: the port's app on ``device="cpu"`` (the plain
version of the fused resize) and the JAX app (its XLA resize) on a
96x1344 source, 3 frames at 24 fps, whose thumbnail is resized to
92x1280, and on the 96x128 source, which is not resized. The test first
holds the resized planes equal (ROADMAP Queue C item 1; the seed is
picked so they agree), then the ``thumbnail.jpg`` bytes. On a host with
no card, the port's app built with the default ``device="cuda"``
answers the grab with the reference's 422 naming the CUDA error, writes
nothing, and serves its other routes.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.fixtures.media import make_y4m, synthetic_yuv_frames
from tests.test_torch_admin_api import (JAX, PKGS, PORT, copy_site,  # noqa: F401
                                        decoded, dump_tables, fresh_state,
                                        norm, serve, site, tree_files)

WIDE = (96, 1344, 5)        # height, width, seed: the thumbnail resizes


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(height, width) from a baseline JPEG's SOF0."""
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    sof = data.index(b"\xff\xc0")
    return (int.from_bytes(data[sof + 5:sof + 7], "big"),
            int.from_bytes(data[sof + 7:sof + 9], "big"))


def flows(site: dict) -> dict[str, list[tuple]]:
    i = site["ids"]
    jpeg = (site["videos"] / site["slugs"]["main"] / "thumbnail.jpg"
            ).read_bytes()
    return {
        "playlists": [
            ("GET", "/api/playlists", None),
            ("POST", "/api/playlists", {"title": "Road Trip"}),
            ("POST", "/api/playlists", {"title": "Road Trip",
                                        "visibility": "private"}),
            ("POST", "/api/playlists", {"title": "x", "visibility": "odd"}),
            ("POST", "/api/playlists/4/videos", {"video_id": i["main"]}),
            ("POST", "/api/playlists/4/videos", {"video_id": i["other"]}),
            ("POST", "/api/playlists/4/videos", {"video_id": "1"}),
            ("POST", "/api/playlists/4/videos", {"video_id": 999}),
            ("POST", "/api/playlists/999/videos", {"video_id": i["main"]}),
            ("PUT", "/api/playlists/4/order",
             {"video_ids": [i["other"], i["main"]]}),
            ("PUT", "/api/playlists/4/order", {"video_ids": [i["other"]]}),
            ("PUT", "/api/playlists/999/order", {"video_ids": []}),
            ("GET", "/api/playlists/4", None),
            ("PATCH", "/api/playlists/4", {"description": "d2",
                                           "visibility": "unlisted"}),
            ("PATCH", "/api/playlists/4", {"title": " "}),
            ("PATCH", "/api/playlists/999", {"title": "y"}),
            ("DELETE", f"/api/playlists/4/videos/{i['main']}", None),
            ("DELETE", f"/api/playlists/4/videos/{i['main']}", None),
            ("GET", "/api/playlists/4", None),
            ("DELETE", "/api/playlists/4", None),
            ("DELETE", "/api/playlists/4", None),
        ],
        "custom_fields": [
            ("GET", "/api/custom-fields", None),
            ("POST", "/api/custom-fields", {"name": "rating",
                                            "field_type": "number",
                                            "required": True}),
            ("POST", "/api/custom-fields", {"name": "rating"}),
            ("POST", "/api/custom-fields", {"name": "kind",
                                            "field_type": "select"}),
            ("POST", "/api/custom-fields", {"name": "kind",
                                            "field_type": "nope"}),
            ("PUT", f"/api/videos/{i['main']}/custom-fields",
             {"rating": 4.5, "director": "Lin"}),
            ("PUT", f"/api/videos/{i['main']}/custom-fields",
             {"rating": "high"}),
            ("PUT", f"/api/videos/{i['main']}/custom-fields", ["no"]),
            ("PUT", "/api/videos/999/custom-fields", {"rating": 1}),
            ("GET", f"/api/videos/{i['main']}/custom-fields", None),
            ("DELETE", "/api/custom-fields/999", None),
        ],
        "transcript": [
            ("GET", f"/api/videos/{i['main']}/transcript", None),
            ("PUT", f"/api/videos/{i['main']}/transcript",
             {"text": "corrected", "vtt": "not vtt"}),
            ("PUT", f"/api/videos/{i['main']}/transcript",
             {"text": "corrected", "vtt":
              "WEBVTT\n\n00:00.000 --> 00:00.500\ncorrected\n"}),
            ("GET", f"/api/videos/{i['main']}/transcript", None),
            ("PUT", "/api/videos/999/transcript", {"text": "x"}),
            ("DELETE", f"/api/videos/{i['main']}/transcript", None),
            ("DELETE", f"/api/videos/{i['main']}/transcript", None),
            ("GET", f"/api/videos/{i['main']}/transcript", None),
        ],
        "bulk": [
            ("POST", "/api/videos/bulk", {"action": "delete",
                                          "video_ids": [i["other"]]}),
            ("POST", "/api/videos/bulk", {"action": "restore",
                                          "video_ids": [i["other"],
                                                        i["deleted"]]}),
            ("POST", "/api/videos/bulk", {"action": "retranscode",
                                          "video_ids": [i["main"], 999]}),
            ("POST", "/api/videos/bulk", {"action": "set_category",
                                          "category": None,
                                          "video_ids": [i["main"]]}),
            ("POST", "/api/videos/bulk", {"action": "delete",
                                          "video_ids": "1"}),
            ("POST", "/api/videos/bulk", {"action": "delete",
                                          "video_ids": list(range(1, 600))}),
        ],
        "thumbnails": [
            ("GET", f"/api/videos/{i['main']}/thumbnail", None),
            ("PUT", f"/api/videos/{i['other']}/thumbnail", jpeg[:-10]),
            ("PUT", f"/api/videos/{i['other']}/thumbnail", b"\xff\xd8"),
            ("PUT", "/api/videos/999/thumbnail", jpeg),
            ("GET", f"/api/videos/{i['other']}/thumbnail", None),
            ("GET", f"/api/videos/{i['pending']}/thumbnail", None),
        ],
        "sprites": [
            ("GET", f"/api/videos/{i['main']}/sprites", None),
            ("GET", f"/api/videos/{i['main']}/sprites/sheet_0001.jpg", None),
            ("GET", f"/api/videos/{i['main']}/sprites/sheet_0002.jpg", None),
            ("GET", f"/api/videos/{i['main']}/sprites/sprites.vtt", None),
            ("GET", "/api/videos/999/sprites", None),
        ],
    }


def run_flow(sites: dict, steps: list[tuple]):
    async def body(apps):
        answers = []
        for method, url, payload in steps:
            kw = ({"data": payload,
                   "headers": {"Content-Type": "image/jpeg"}}
                  if isinstance(payload, bytes) else
                  {} if payload is None else {"json": payload})
            got = {}
            for pkg in PKGS:
                r = await apps.client[pkg].request(method, url, **kw)
                ct = r.headers.get("Content-Type", "").split(";")[0]
                got[pkg] = (r.status, ct, decoded(await r.read(), ct,
                                                  (sites[pkg]["root"],)))
            answers.append((method, url, got))
        tables = {pkg: norm(await dump_tables(apps.db[pkg]),
                            (sites[pkg]["root"],)) for pkg in PKGS}
        return answers, tables

    return serve(sites, body)


@pytest.mark.parametrize("flow", ["playlists", "custom_fields", "transcript",
                                  "bulk", "thumbnails", "sprites"])
def test_catalog_flow_alike(site, tmp_path, flow):
    sites = {pkg: copy_site(site, tmp_path / pkg) for pkg in PKGS}
    answers, tables = run_flow(sites, flows(sites[PORT])[flow])
    for method, url, got in answers:
        assert got[PORT] == got[JAX], (method, url)
    assert tables[PORT] == tables[JAX]
    assert tree_files(sites[PORT]["videos"]) == \
        tree_files(sites[JAX]["videos"])
    ok = [got[PORT][0] for _, _, got in answers if got[PORT][0] < 300]
    assert ok, flow


# --------------------------------------------------------------------------
# thumbnail/from-time
# --------------------------------------------------------------------------

def _planes_agree(h: int, w: int, seed: int, frame: int) -> None:
    """The JAX app's resize of the frame and the port's plain version
    agree at the thumbnail geometry."""
    import jax.numpy as jnp
    import torch

    from vlog_tpu.ops.resize import resize_yuv420 as jax_resize
    from vlog_tpu_torch.backends.torch_backend import TorchBackend

    y, u, v = synthetic_yuv_frames(frame + 1, w, h, seed=seed)[frame]
    th = max(2, round(h * 1280 / w / 2) * 2)
    want = jax_resize(*(jnp.asarray(p[None]) for p in (y, u, v)), th, 1280)
    got = TorchBackend(device="cpu")._thumbnail_planes(y, u, v)
    for a, b in zip(want, got):
        diff = np.abs(np.asarray(a[0], np.int16) - b.numpy().astype(np.int16))
        print(f"thumbnail plane {b.shape}: max |diff| {diff.max()}, "
              f"{int((diff > 0).sum())} pixels differ")
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(a[0]), b.numpy())


@pytest.mark.parametrize("shape", [WIDE, (96, 128, 3)],
                         ids=["resized", "source-size"])
def test_thumbnail_from_time_matches_jax(site, tmp_path, shape):
    h, w, seed = shape
    sites = {pkg: copy_site(site, tmp_path / pkg) for pkg in PKGS}
    main = site["ids"]["main"]
    for pkg in PKGS:
        make_y4m(sites[pkg]["root"] / "src.y4m", n_frames=3, width=w,
                 height=h, fps=24, seed=seed)
    if w > 1280:
        _planes_agree(h, w, seed, frame=1)
    steps = [
        ("POST", f"/api/videos/{main}/thumbnail/from-time",
         {"time_s": 1 / 24}),
        ("GET", f"/api/videos/{main}/thumbnail", None),
        ("POST", f"/api/videos/{main}/thumbnail/from-time",
         {"time_s": "soon"}),
        ("POST", f"/api/videos/{site['ids']['pending']}/thumbnail/from-time",
         {"time_s": 0}),
        ("POST", "/api/videos/999/thumbnail/from-time", {"time_s": 0}),
    ]
    answers, tables = run_flow(sites, steps)
    for method, url, got in answers:
        assert got[PORT] == got[JAX], (method, url)
    assert [got[PORT][0] for _, _, got in answers] == [200, 200, 400, 404,
                                                       404]
    assert tables[PORT] == tables[JAX]
    thumb = {pkg: (sites[pkg]["videos"] / site["slugs"]["main"] /
                   "thumbnail.jpg").read_bytes() for pkg in PKGS}
    assert thumb[PORT] == thumb[JAX]
    assert jpeg_size(thumb[PORT]) == ((92, 1280) if w > 1280 else (h, w))
    # a time past the end grabs the last frame; a source gone is a 409
    for pkg in PKGS:
        (sites[pkg]["root"] / "src.y4m").unlink()
    answers, _ = run_flow(sites, [
        ("POST", f"/api/videos/{main}/thumbnail/from-time", {"time_s": 0})])
    assert answers[0][2][PORT] == answers[0][2][JAX]
    assert answers[0][2][PORT][0] == 409


def test_thumbnail_from_time_past_the_end_takes_the_last_frame(site,
                                                              tmp_path):
    sites = {pkg: copy_site(site, tmp_path / pkg) for pkg in PKGS}
    main = site["ids"]["main"]
    for pkg in PKGS:
        make_y4m(sites[pkg]["root"] / "src.y4m", n_frames=3, width=128,
                 height=96, fps=24, seed=9)
    answers, _ = run_flow(sites, [
        ("POST", f"/api/videos/{main}/thumbnail/from-time", {"time_s": 60})])
    assert answers[0][2][PORT] == answers[0][2][JAX]
    last = {pkg: (sites[pkg]["videos"] / site["slugs"]["main"] /
                  "thumbnail.jpg").read_bytes() for pkg in PKGS}
    assert last[PORT] == last[JAX]
    answers, _ = run_flow(sites, [
        ("POST", f"/api/videos/{main}/thumbnail/from-time",
         {"time_s": 2 / 24})])
    assert (sites[PORT]["videos"] / site["slugs"]["main"] /
            "thumbnail.jpg").read_bytes() == last[PORT]


def test_thumbnail_from_time_without_a_card_is_a_422(site, tmp_path):
    """The default device is the card: on a host without one the grab
    names the CUDA error and writes nothing; the other routes serve."""
    import asyncio

    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from vlog_tpu_torch.api.admin_api import build_admin_app
    from vlog_tpu_torch.db import Database

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    s = copy_site(site, tmp_path / "port")
    make_y4m(s["root"] / "src.y4m", n_frames=3, width=128, height=96,
             fps=24)
    thumb = s["videos"] / s["slugs"]["main"] / "thumbnail.jpg"
    before = thumb.read_bytes()

    async def body():
        db = Database(s["db_url"])
        await db.connect()
        client = TestClient(TestServer(build_admin_app(
            db, upload_dir=s["root"] / "uploads", video_dir=s["videos"])))
        await client.start_server()
        try:
            r = await client.post(
                f"/api/videos/{s['ids']['main']}/thumbnail/from-time",
                json={"time_s": 0})
            grab = (r.status, await r.json())
            r = await client.get("/api/playlists")
            other = r.status
        finally:
            await client.close()
            await db.disconnect()
        return grab, other

    async def bounded():
        async with asyncio.timeout(60):
            return await body()

    loop = asyncio.new_event_loop()
    try:
        grab, other = loop.run_until_complete(bounded())
    finally:
        loop.close()
    assert grab[0] == 422
    assert grab[1]["error"].startswith("thumbnail grab failed: ")
    assert "CUDA is not available" in grab[1]["error"]
    assert other == 200
    assert thumb.read_bytes() == before
