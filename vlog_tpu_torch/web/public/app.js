/* Public SPA: #/ browse grid, #/v/{slug} watch page.
 * Data: vlog_tpu.api.public_api (/api/videos, /api/categories,
 * /api/videos/{slug}/transcript, playback sessions).
 */
"use strict";
import { CmafPlayer } from "/ui/player.js";

const $ = (id) => document.getElementById(id);
const PAGE = 24;
let state = { offset: 0, total: 0, q: "", category: "", tag: "",
              playlist: "" };
let player = null;
let session = null;        // {token, timer, watched}
let watchCleanup = [];     // undo-list for listeners/timers of the open video
let gridSeq = 0;           // drops stale /api/videos responses

function fmtDur(s) {
  s = Math.round(s || 0);
  const h = (s / 3600) | 0, m = ((s % 3600) / 60) | 0, sec = s % 60;
  return (h ? `${h}:${String(m).padStart(2, "0")}` : `${m}`) + ":" + String(sec).padStart(2, "0");
}

async function j(url, opts) {
  const r = await fetch(url, opts);
  if (!r.ok) throw new Error(`${url}: HTTP ${r.status}`);
  return r.json();
}

/* ------------------------------------------------- browse ------------ */

async function loadCategories() {
  try {
    const d = await j("/api/categories");
    for (const c of d.categories) {
      const o = document.createElement("option");
      o.value = c.category;
      o.textContent = `${c.category} (${c.n})`;
      $("category").appendChild(o);
    }
  } catch (e) { /* category filter is optional */ }
}

async function loadTags() {
  try {
    const d = await j("/api/tags");
    const strip = $("tagstrip");
    strip.textContent = "";
    for (const t of d.tags.slice(0, 20)) {
      const b = document.createElement("button");
      b.className = "tagchip" + (state.tag === t.tag ? " active" : "");
      b.textContent = `#${t.tag} (${t.count})`;
      b.onclick = () => {
        state.tag = state.tag === t.tag ? "" : t.tag;
        state.offset = 0;
        loadTags();
        loadGrid();
      };
      strip.appendChild(b);
    }
  } catch (e) { /* tag strip is optional */ }
}

async function loadPlaylistsRow() {
  try {
    const d = await j("/api/playlists");
    const row = $("playlists-row");
    row.textContent = "";
    for (const p of d.playlists.slice(0, 12)) {
      const b = document.createElement("button");
      b.className = "tagchip pl" + (state.playlist === p.slug ? " active" : "");
      b.textContent = `▸ ${p.title} (${p.video_count})`;
      b.onclick = () => {
        state.playlist = state.playlist === p.slug ? "" : p.slug;
        state.offset = 0;
        loadPlaylistsRow();
        loadGrid();
      };
      row.appendChild(b);
    }
  } catch (e) { /* playlists row is optional */ }
}

async function loadGrid() {
  const seq = ++gridSeq;
  let d;
  const heading = $("browse-heading");
  if (state.playlist) {
    const pd = await j(`/api/playlists/${encodeURIComponent(state.playlist)}`);
    d = { videos: pd.videos, total: pd.videos.length };
    heading.hidden = false;
    heading.textContent = `Playlist: ${pd.playlist.title}`;
  } else if (state.tag) {
    const p = new URLSearchParams({ limit: PAGE, offset: state.offset });
    d = await j(`/api/tags/${encodeURIComponent(state.tag)}/videos?${p}`);
    heading.hidden = false;
    heading.textContent = `#${state.tag}`;
  } else {
    const p = new URLSearchParams({ limit: PAGE, offset: state.offset });
    if (state.q) p.set("q", state.q);
    if (state.category) p.set("category", state.category);
    d = await j(`/api/videos?${p}`);
    heading.hidden = true;
  }
  if (seq !== gridSeq) return;   // a newer query superseded this response
  state.total = d.total;
  const grid = $("grid");
  grid.textContent = "";
  $("empty").hidden = d.videos.length > 0;
  for (const v of d.videos) {
    const card = document.createElement("div");
    card.className = "card";
    card.onclick = () => { location.hash = `#/v/${v.slug}`; };
    const thumb = document.createElement("div");
    thumb.className = "thumb";
    if (v.thumbnail_url) thumb.style.backgroundImage = `url('${v.thumbnail_url}')`;
    else thumb.textContent = "▶";
    const dur = document.createElement("span");
    dur.className = "dur";
    dur.textContent = fmtDur(v.duration_s);
    thumb.appendChild(dur);
    const body = document.createElement("div");
    body.className = "body";
    const title = document.createElement("p");
    title.className = "title";
    title.textContent = v.title;
    const meta = document.createElement("span");
    meta.className = "dim";
    meta.textContent = `${v.height ? v.height + "p · " : ""}${new Date(v.created_at * 1000).toLocaleDateString()}`;
    body.append(title, meta);
    card.append(thumb, body);
    grid.appendChild(card);
  }
  const page = (state.offset / PAGE | 0) + 1;
  const pages = Math.max(1, Math.ceil(state.total / PAGE));
  $("page-info").textContent = `${page} / ${pages} · ${state.total} videos`;
  $("prev").disabled = state.offset === 0;
  $("next").disabled = state.offset + PAGE >= state.total;
}

/* ------------------------------------------------- watch ------------- */

async function startAnalytics(slug, video) {
  try {
    const d = await j(`/api/videos/${slug}/session`, { method: "POST" });
    session = { token: d.session, watched: 0, timer: 0 };
    const mySession = session;
    let last = 0;
    const onTime = () => {
      const t = video.currentTime;
      if (t > last && t - last < 2) mySession.watched += t - last;
      last = t;
    };
    video.addEventListener("timeupdate", onTime);
    watchCleanup.push(() => video.removeEventListener("timeupdate", onTime));
    session.timer = setInterval(() => {
      if (!session) return;
      fetch("/api/sessions/heartbeat", {
        method: "POST", headers: { "Content-Type": "application/json" },
        body: JSON.stringify({ session: session.token, watch_time_s: session.watched }),
      }).catch(() => {});
    }, 15000);
    window.addEventListener("pagehide", endAnalytics, { once: true });
  } catch (e) { /* analytics must never break playback */ }
}

function endAnalytics() {
  if (!session) return;
  clearInterval(session.timer);
  const body = JSON.stringify({ session: session.token, watch_time_s: session.watched });
  if (navigator.sendBeacon) {
    navigator.sendBeacon("/api/sessions/end", new Blob([body], { type: "application/json" }));
  } else {
    fetch("/api/sessions/end", { method: "POST", headers: { "Content-Type": "application/json" }, body }).catch(() => {});
  }
  session = null;
}

async function loadTranscript(slug, video) {
  const el = $("transcript");
  el.textContent = "No transcript.";
  el.classList.add("dim");
  try {
    const d = await j(`/api/videos/${slug}/transcript`);
    const vtt = await (await fetch(d.vtt_url)).text();
    const cues = [];
    // WEBVTT cue blocks: "hh:mm:ss.mmm --> hh:mm:ss.mmm" then text lines
    const re = /(\d+):(\d\d):(\d\d)\.(\d+)\s+-->\s+(\d+):(\d\d):(\d\d)\.\d+\n((?:[^\n]+\n?)+)/g;
    let m;
    while ((m = re.exec(vtt)) !== null) {
      cues.push({
        start: (+m[1]) * 3600 + (+m[2]) * 60 + (+m[3]) + (+m[4]) / 1000,
        text: m[8].trim().replace(/\n/g, " "),
      });
    }
    if (!cues.length) return;
    el.textContent = "";
    el.classList.remove("dim");
    const nodes = cues.map((c) => {
      const div = document.createElement("div");
      div.className = "cue";
      const t = document.createElement("span");
      t.className = "t";
      t.textContent = fmtDur(c.start);
      div.append(t, document.createTextNode(c.text));
      div.onclick = () => { video.currentTime = c.start; video.play(); };
      el.appendChild(div);
      return div;
    });
    // transcript search: filter cues by substring
    const search = $("tr-search");
    search.hidden = false;
    search.value = "";
    search.oninput = () => {
      const needle = search.value.trim().toLowerCase();
      nodes.forEach((n, i) => {
        n.hidden = needle !== "" &&
          !cues[i].text.toLowerCase().includes(needle);
      });
    };
    watchCleanup.push(() => { search.hidden = true; search.oninput = null; });
    // native captions overlay
    const track = document.createElement("track");
    track.kind = "captions"; track.label = d.language || "captions";
    track.src = d.vtt_url; track.default = true;
    video.appendChild(track);
    const onCueTime = () => {
      const t = video.currentTime;
      let live = -1;
      for (let i = 0; i < cues.length; i++) if (cues[i].start <= t) live = i;
      nodes.forEach((n, i) => n.classList.toggle("live", i === live));
    };
    video.addEventListener("timeupdate", onCueTime);
    watchCleanup.push(() => video.removeEventListener("timeupdate", onCueTime));
  } catch (e) { /* 404 = no transcript */ }
}

let watchSeq = 0;           // drops stale openWatch responses

/* Sprite-preview seek strip under the player: hover shows the tile
   from the sprite sheets (worker/sprites.py), click seeks. */
async function loadSeekStrip(v, video, seq) {
  const strip = $("seek-strip");
  const preview = $("seek-preview");
  strip.hidden = true;
  if (!v.sprites_url) return;
  let cues = [];
  try {
    const vtt = await (await fetch(v.sprites_url)).text();
    if (seq !== watchSeq) return;   // user navigated away mid-fetch
    const re = /([\d:.]+)\s+-->\s+([\d:.]+)\s*\n(\S+)#xywh=(\d+),(\d+),(\d+),(\d+)/g;
    const secs = (t) => t.split(":").reduce((a, x) => a * 60 + (+x), 0);
    const base = v.sprites_url.slice(0, v.sprites_url.lastIndexOf("/") + 1);
    let m;
    while ((m = re.exec(vtt)) !== null) {
      cues.push({ start: secs(m[1]), end: secs(m[2]), url: base + m[3],
        x: +m[4], y: +m[5], w: +m[6], h: +m[7] });
    }
  } catch (e) { return; }
  if (!cues.length) return;
  strip.hidden = false;
  const played = $("seek-played");
  const onTime = () => {
    const d = video.duration || v.duration_s || 1;
    played.style.width = `${(video.currentTime / d) * 100}%`;
  };
  video.addEventListener("timeupdate", onTime);
  const frac = (ev) => {
    const r = strip.getBoundingClientRect();
    return Math.min(Math.max((ev.clientX - r.left) / r.width, 0), 1);
  };
  strip.onmousemove = (ev) => {
    const d = video.duration || v.duration_s || 1;
    const t = frac(ev) * d;
    const cue = cues.find((c) => t >= c.start && t < c.end)
      || cues[cues.length - 1];
    preview.style.display = "block";
    preview.style.width = `${cue.w}px`;
    preview.style.height = `${cue.h}px`;
    preview.style.left = `${frac(ev) * 100}%`;
    preview.style.background = `url(${cue.url}) -${cue.x}px -${cue.y}px`;
    preview.querySelector(".t").textContent = fmtDur(t);
  };
  strip.onmouseleave = () => { preview.style.display = "none"; };
  strip.onclick = (ev) => {
    const d = video.duration || v.duration_s || 1;
    video.currentTime = frac(ev) * d;
    video.play();
  };
  watchCleanup.push(() => {
    video.removeEventListener("timeupdate", onTime);
    strip.hidden = true;
    strip.onmousemove = strip.onclick = strip.onmouseleave = null;
  });
}

async function openWatch(slug) {
  const seq = ++watchSeq;
  const d = await j(`/api/videos/${slug}`);
  if (seq !== watchSeq) return;   // user already navigated elsewhere
  const v = d.video;
  $("v-title").textContent = v.title;
  $("v-desc").textContent = v.description || "";
  $("v-meta").textContent =
    `${v.width}×${v.height} · ${fmtDur(v.duration_s)} · ` +
    `${v.qualities.map((q) => q.name).join(" ")}`;
  const chapEl = $("chapters");
  chapEl.textContent = "";
  const video = $("player");

  for (const c of v.chapters || []) {
    const b = document.createElement("button");
    b.textContent = `${fmtDur(c.start_s)} ${c.title}`;
    b.onclick = () => { video.currentTime = c.start_s; video.play(); };
    chapEl.appendChild(b);
  }

  $("player-fallback").hidden = true;
  player = new CmafPlayer(video, v.stream_url, {
    onqualitychange: (i) => {
      const sel = $("quality");
      if (sel.dataset.auto === "1") sel.selectedIndex = 0;
    },
    onerror: () => {
      $("player-fallback").hidden = false;
      $("player-fallback").textContent =
        "Playback failed in this browser. Direct streams: " ;
      const a = document.createElement("a");
      a.href = v.dash_url; a.textContent = "DASH manifest";
      $("player-fallback").appendChild(a);
    },
  });
  try {
    await player.load();
    const sel = $("quality");
    sel.textContent = "";
    sel.dataset.auto = "1";
    const auto = document.createElement("option");
    auto.value = "-1"; auto.textContent = "Auto";
    sel.appendChild(auto);
    player.variants.forEach((va, i) => {
      const o = document.createElement("option");
      o.value = String(i);
      o.textContent = `${va.height}p`;
      sel.appendChild(o);
    });
    sel.onchange = () => {
      sel.dataset.auto = sel.value === "-1" ? "1" : "0";
      player.setQuality(parseInt(sel.value, 10));
    };
    const bwTimer = setInterval(() => {
      if (player && player.bwEst) $("bw").textContent = `${(player.bwEst / 1e6).toFixed(1)} Mb/s`;
    }, 2000);
    watchCleanup.push(() => clearInterval(bwTimer));
  } catch (e) {
    player.onerror(e);
  }
  loadTranscript(slug, video);
  loadSeekStrip(v, video, seq);
  loadPlaylistQueue(slug, video, seq);
  loadRelated(slug);
  startAnalytics(slug, video);
}

/* Playlist watch queue: when a video was opened from a playlist, the
   side column lists the playlist order, highlights the current entry,
   and the player auto-advances on ended (reference public player's
   playlist continuation). */
async function loadPlaylistQueue(slug, video, seq) {
  const box = $("pl-queue");
  box.hidden = true;
  if (!state.playlist) return;
  let pd;
  try {
    pd = await j(`/api/playlists/${encodeURIComponent(state.playlist)}`);
  } catch (e) { return; }
  if (seq !== watchSeq) return;
  const vids = pd.videos || [];
  const idx = vids.findIndex((x) => x.slug === slug);
  if (idx < 0) return;
  box.hidden = false;
  $("pl-queue-title").textContent =
    `${pd.playlist.title} (${idx + 1}/${vids.length})`;
  const list = $("pl-queue-list");
  list.textContent = "";
  vids.forEach((x, i) => {
    const b = document.createElement("button");
    b.textContent = `${i + 1}. ${x.title}`;
    if (i === idx) b.className = "active";
    b.onclick = () => { location.hash = `#/v/${x.slug}`; };
    list.appendChild(b);
  });
  const onEnded = () => {
    const next = vids[idx + 1];
    if (next) location.hash = `#/v/${next.slug}`;
  };
  video.addEventListener("ended", onEnded);
  watchCleanup.push(() => {
    video.removeEventListener("ended", onEnded);
    box.hidden = true;
  });
}

async function loadRelated(slug) {
  const el = $("related");
  el.textContent = "—";
  el.classList.add("dim");
  try {
    const d = await j(`/api/videos/${encodeURIComponent(slug)}/related`);
    if (!d.videos.length) return;
    el.textContent = "";
    el.classList.remove("dim");
    for (const v of d.videos.slice(0, 8)) {
      const a = document.createElement("a");
      a.className = "related-item";
      a.href = `#/v/${v.slug}`;
      const t = document.createElement("span");
      t.className = "title";
      t.textContent = v.title;
      const m = document.createElement("span");
      m.className = "dim";
      m.textContent = fmtDur(v.duration_s);
      a.append(t, m);
      el.appendChild(a);
    }
  } catch (e) { /* related rail is optional */ }
}

function closeWatch() {
  watchSeq++;               // invalidate any in-flight openWatch
  endAnalytics();
  for (const undo of watchCleanup.splice(0)) undo();
  if (player) { player.destroy(); player = null; }
  const video = $("player");
  video.querySelectorAll("track").forEach((t) => t.remove());
}

/* ------------------------------------------------- routing ----------- */

function route() {
  const h = location.hash || "#/";
  const watch = h.startsWith("#/v/");
  $("view-browse").hidden = watch;
  $("view-watch").hidden = !watch;
  closeWatch();
  if (watch) openWatch(decodeURIComponent(h.slice(4)));
  else loadGrid();
}

let searchTimer = 0;
$("search").addEventListener("input", () => {
  clearTimeout(searchTimer);
  searchTimer = setTimeout(() => {
    state.q = $("search").value.trim();
    state.offset = 0;
    if (!location.hash || location.hash === "#/") loadGrid();
    else location.hash = "#/";
  }, 200);
});
$("category").addEventListener("change", () => {
  state.category = $("category").value;
  state.offset = 0;
  loadGrid();
});
$("prev").onclick = () => { state.offset = Math.max(0, state.offset - PAGE); loadGrid(); };
$("next").onclick = () => { state.offset += PAGE; loadGrid(); };
window.addEventListener("hashchange", route);

loadCategories();
loadTags();
loadPlaylistsRow();
route();
