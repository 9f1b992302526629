/* First-party MSE player for the CMAF/fMP4 HLS this framework emits.
 *
 * Speaks exactly the dialect of media/hls.py: a master playlist with
 * EXT-X-STREAM-INF variants (CODECS + optional AUDIO group), audio
 * renditions as EXT-X-MEDIA rows, and per-rung media playlists carrying
 * EXT-X-MAP init segments plus EXTINF'd .m4s fragments. Segment
 * timelines are aligned across rungs (one segmenter cut them), so
 * quality switching is: append the new rung's init, keep the segment
 * index. Timestamps are absolute via tfdt, so no timestampOffset games.
 *
 * Reference parity: the reference's web/public player delegates to
 * hls.js; we do not vendor third-party JS, so this is the from-scratch
 * equivalent for our own output envelope (VOD, aligned rungs, fMP4).
 */
"use strict";

const AHEAD_S = 30;          // keep this much buffered past the playhead
const BW_SAFETY = 1.3;       // only switch up if est bandwidth > 1.3x need
const EWMA_ALPHA = 0.35;
// ABR hysteresis (abrDecision): a healthy buffer earns an up-switch,
// a draining one forces a down-switch, and a cooldown stops oscillation
const UP_MIN_BUFFER_S = 10;
const DOWN_BUFFER_S = 5;
const SWITCH_COOLDOWN_S = 3;

/* Pure rate-adaptation rule — kept side-effect-free so it is testable
 * outside a browser. state: {variant, bandwidths[], bwEst, bufferS,
 * sinceSwitchS, stalled}. Returns the target variant index. */
export function abrDecision(state) {
  const { variant, bandwidths, bwEst, bufferS, sinceSwitchS, stalled } = state;
  const sustainable = () => {
    let best = 0;
    for (let i = 0; i < bandwidths.length; i++) {
      if (bandwidths[i] * BW_SAFETY <= bwEst) best = i;
    }
    return best;
  };
  if (stalled) {
    // playback caught the buffer: drop straight to what the link can
    // actually carry (no cooldown — a stall IS the evidence)
    return Math.min(variant, sustainable());
  }
  if (!bwEst || sinceSwitchS < SWITCH_COOLDOWN_S) return variant;
  const want = sustainable();
  if (want > variant) {
    // climb one rung at a time, and only from a healthy buffer: a
    // mis-estimate then costs one rung, not a stall
    return bufferS >= UP_MIN_BUFFER_S ? variant + 1 : variant;
  }
  if (want < variant) {
    // down-switch when the buffer is draining or the link clearly
    // cannot carry the current rung
    if (bufferS < DOWN_BUFFER_S || bwEst < bandwidths[variant]) return want;
  }
  return variant;
}

function parseAttrs(s) {
  // ATTR=VAL,ATTR="quoted,val" ...
  const out = {};
  const re = /([A-Z0-9-]+)=("[^"]*"|[^,]*)/g;
  let m;
  while ((m = re.exec(s)) !== null) {
    let v = m[2];
    if (v.startsWith('"')) v = v.slice(1, -1);
    out[m[1]] = v;
  }
  return out;
}

export function parseMaster(text, baseUrl) {
  const variants = [];
  const audio = {};          // group-id -> rendition (DEFAULT=YES wins)
  const lines = text.split(/\r?\n/);
  for (let i = 0; i < lines.length; i++) {
    const ln = lines[i].trim();
    if (ln.startsWith("#EXT-X-MEDIA:")) {
      const a = parseAttrs(ln.slice(13));
      if (a.TYPE === "AUDIO" && a.URI) {
        const r = {
          group: a["GROUP-ID"], name: a.NAME || a["GROUP-ID"],
          url: new URL(a.URI, baseUrl).href,
          isDefault: a.DEFAULT === "YES",
        };
        if (!audio[r.group] || r.isDefault) audio[r.group] = r;
      }
    } else if (ln.startsWith("#EXT-X-STREAM-INF:")) {
      const a = parseAttrs(ln.slice(18));
      let uri = "";
      for (let j = i + 1; j < lines.length; j++) {
        const cand = lines[j].trim();
        if (cand && !cand.startsWith("#")) { uri = cand; i = j; break; }
      }
      if (!uri) continue;
      const res = (a.RESOLUTION || "x").split("x");
      variants.push({
        bandwidth: parseInt(a.BANDWIDTH || "0", 10),
        width: parseInt(res[0] || "0", 10),
        height: parseInt(res[1] || "0", 10),
        codecs: a.CODECS || "",
        audioGroup: a.AUDIO || "",
        url: new URL(uri, baseUrl).href,
      });
    }
  }
  variants.sort((x, y) => x.bandwidth - y.bandwidth);
  return { variants, audio };
}

export function parseMedia(text, baseUrl) {
  const segs = [];
  let init = null, dur = 0, t = 0;
  const lines = text.split(/\r?\n/);
  for (let i = 0; i < lines.length; i++) {
    const ln = lines[i].trim();
    if (ln.startsWith("#EXT-X-MAP:")) {
      const a = parseAttrs(ln.slice(11));
      if (a.URI) init = new URL(a.URI, baseUrl).href;
    } else if (ln.startsWith("#EXTINF:")) {
      dur = parseFloat(ln.slice(8));
    } else if (ln && !ln.startsWith("#")) {
      segs.push({ url: new URL(ln, baseUrl).href, start: t, dur });
      t += dur;
    }
  }
  return { init, segs, duration: t };
}

function waitEvent(target, name) {
  return new Promise((res) => target.addEventListener(name, res, { once: true }));
}

/* One SourceBuffer fed sequentially from a segment playlist. */
class Track {
  constructor(player, mime) {
    this.player = player;
    this.sb = player.ms.addSourceBuffer(mime);
    this.playlist = null;     // {init, segs, duration}
    this.pos = 0;             // next segment index to append
    this.pendingInit = null;  // init bytes to append before next segment
    this.busy = false;
    this.done = false;
    this.sb.addEventListener("updateend", () => { this.busy = false; this.player.pump(); });
  }

  async setPlaylist(url, fromTime) {
    const text = await (await fetch(url)).text();
    this.playlist = parseMedia(text, url);
    this.pos = this.indexAt(fromTime);
    this.done = false;
    if (this.playlist.init) {
      const r = await fetch(this.playlist.init);
      this.pendingInit = new Uint8Array(await r.arrayBuffer());
    }
  }

  indexAt(t) {
    const segs = this.playlist.segs;
    for (let i = 0; i < segs.length; i++) {
      if (segs[i].start + segs[i].dur > t + 0.01) return i;
    }
    return segs.length;
  }

  bufferedAhead(t) {
    const b = this.sb.buffered;
    for (let i = 0; i < b.length; i++) {
      if (b.start(i) <= t + 0.25 && b.end(i) > t) return b.end(i) - t;
    }
    return 0;
  }

  seekTo(t) {
    if (this.bufferedAhead(t) > 0.5) return;   // already there
    this.pos = this.indexAt(t);
    this.done = this.pos >= this.playlist.segs.length;
  }

  /* Append at most one thing (init or segment); returns true if work started. */
  step(now) {
    if (this.busy || !this.playlist || this.sb.updating) return false;
    if (this.pendingInit) {
      const bytes = this.pendingInit;
      this.pendingInit = null;
      this.busy = true;
      this.sb.appendBuffer(bytes);
      return true;
    }
    if (this.pos >= this.playlist.segs.length) { this.done = true; return false; }
    if (this.bufferedAhead(now) >= AHEAD_S) return false;
    const seg = this.playlist.segs[this.pos++];
    this.busy = true;
    const t0 = performance.now();
    fetch(seg.url)
      .then((r) => r.arrayBuffer())
      .then((buf) => {
        this.player.observeBandwidth(buf.byteLength, (performance.now() - t0) / 1000);
        try {
          this.sb.appendBuffer(buf);
        } catch (e) {
          if (e.name === "QuotaExceededError") {
            // evict behind the playhead, retry this segment next pump
            const end = this.player.video.currentTime - 10;
            if (end > 0.5) {
              this.pos--;
              this.busy = true;
              this.sb.remove(0, end);   // remove() needs end > start
            } else {
              throw e;   // nothing evictable: surface the failure
            }
          } else { throw e; }
        }
      })
      .catch((e) => { this.busy = false; this.player.onerror(e); });
    return true;
  }
}

export class CmafPlayer {
  constructor(video, masterUrl, opts = {}) {
    this.video = video;
    // new URL(rel, base) needs an absolute base; callers pass API-relative
    // paths like /videos/{slug}/master.m3u8
    this.masterUrl = new URL(masterUrl, window.location.href).href;
    this.onqualitychange = opts.onqualitychange || (() => {});
    this.onerror = opts.onerror || ((e) => console.error("player:", e));
    this.auto = true;
    this.bwEst = 0;
    this.variant = -1;
    this._switching = false;
    this._lastSwitchAt = 0;    // performance.now()/1000 of last switch
    this._stalled = false;
  }

  async load() {
    if (!window.MediaSource) throw new Error("MediaSource unsupported");
    const text = await (await fetch(this.masterUrl)).text();
    const { variants, audio } = parseMaster(text, this.masterUrl);
    if (!variants.length) throw new Error("empty master playlist");
    this.variants = variants;
    this.audioRendition = variants[0].audioGroup
      ? audio[variants[0].audioGroup] : null;

    this.ms = new MediaSource();
    this.msUrl = URL.createObjectURL(this.ms);
    this.video.src = this.msUrl;
    await waitEvent(this.ms, "sourceopen");

    const v0 = 0; // open at the lowest rung; auto-switch climbs fast
    this.videoTrack = new Track(this, this.mimeFor(variants[v0], "video"));
    if (this.audioRendition) {
      this.audioTrack = new Track(this, 'audio/mp4; codecs="mp4a.40.2"');
      await this.audioTrack.setPlaylist(this.audioRendition.url, 0);
    }
    await this._applyVariant(v0, 0);
    if (this.ms.duration !== this.videoTrack.playlist.duration) {
      try { this.ms.duration = this.videoTrack.playlist.duration; } catch (e) { /* ok */ }
    }
    this.video.addEventListener("timeupdate", () => this.pump());
    // a rebuffer is hard evidence the current rung is too heavy
    this.video.addEventListener("waiting", () => {
      this._stalled = true;
      this.pump();
    });
    this.video.addEventListener("playing", () => { this._stalled = false; });
    this.video.addEventListener("seeking", () => {
      const t = this.video.currentTime;
      this.videoTrack.seekTo(t);
      if (this.audioTrack) this.audioTrack.seekTo(t);
      this.pump();
    });
    this.pump();
  }

  mimeFor(variant, kind) {
    const parts = variant.codecs.split(",").map((s) => s.trim()).filter(Boolean);
    const vid = parts.filter((c) => !c.startsWith("mp4a"));
    const list = kind === "video" && this.audioRendition ? vid : parts;
    return `${kind}/mp4; codecs="${list.join(",") || "avc1.42C01E"}"`;
  }

  async _applyVariant(i, fromTime) {
    this.variant = i;
    await this.videoTrack.setPlaylist(this.variants[i].url, fromTime);
    this.onqualitychange(i, this.variants[i]);
  }

  async setQuality(i) {           // i === -1 -> auto
    if (i === -1) { this.auto = true; return; }
    this.auto = false;
    await this._switchTo(i);
  }

  async _switchTo(i) {
    if (i === this.variant || this._switching) return;
    this._switching = true;
    try {
      await this._applyVariant(i, this.video.currentTime);
      this.pump();
    } finally { this._switching = false; }
  }

  observeBandwidth(bytes, secs) {
    if (secs <= 0) return;
    const bps = (bytes * 8) / secs;
    this.bwEst = this.bwEst ? EWMA_ALPHA * bps + (1 - EWMA_ALPHA) * this.bwEst : bps;
  }

  pump() {
    if (!this.videoTrack || this._switching) return;
    const now = this.video.currentTime;
    if (this.auto && this.variants.length > 1) {
      const want = abrDecision({
        variant: this.variant,
        bandwidths: this.variants.map((v) => v.bandwidth),
        bwEst: this.bwEst,
        bufferS: this.videoTrack.bufferedAhead(now),
        sinceSwitchS: performance.now() / 1000 - this._lastSwitchAt,
        stalled: this._stalled,
      });
      if (want !== this.variant) {
        this._stalled = false;
        this._lastSwitchAt = performance.now() / 1000;
        this._switchTo(want);
        return;
      }
    }
    this.videoTrack.step(now);
    if (this.audioTrack) this.audioTrack.step(now);
    const allDone = this.videoTrack.done && (!this.audioTrack || this.audioTrack.done)
      && !this.videoTrack.busy && (!this.audioTrack || !this.audioTrack.busy);
    if (allDone && this.ms.readyState === "open") {
      try { this.ms.endOfStream(); } catch (e) { /* already ending */ }
    }
  }

  destroy() {
    if (this.msUrl) {
      try { URL.revokeObjectURL(this.msUrl); } catch (e) { /* ok */ }
      this.msUrl = null;
    }
    try { this.video.removeAttribute("src"); this.video.load(); } catch (e) { /* ok */ }
  }
}
