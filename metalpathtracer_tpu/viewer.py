"""Interactive progressive viewer — the reference's front-end, reborn in the
terminal.

The reference is an AppKit window + MTKView redrawing at 60 Hz
(`MetalCpp Path Tracer/Window/*`), with WASD/mouse camera controls that were
implemented but never wired in (`ControllerView.mm` has no caller —
SURVEY.md §2#5, appendix 6). This viewer completes the intended loop
(SURVEY.md §3.3):

    key/mouse event → InputState → apply_inputs → camera changed?
        → reset accumulation : keep accumulating → draw

Rendering uses the persistent-wavefront integrator (the fast path) and
overlaps the device dispatch with input polling: while the device traces,
the host keeps draining the event queue, so controls stay live at any
frame rate. Output goes to the terminal as 24-bit-color half-block
characters (two image rows per text row), so it runs over SSH with zero
display deps.

Controls (mouse needs an xterm-compatible terminal; keys always work):

    mouse drag      rotate (ControllerView.mm:41-44, now wired)
    scroll wheel    zoom (ControllerView.mm:71-73)
    w/a/s/d         move (horizontal, y-locked like the reference)
    space/c         up / down
    arrows          rotate (yaw/pitch)
    +/-             zoom (fov)
    r               reset camera        p  save PNG to runs/
    q               quit
"""

from __future__ import annotations

import os
import select
import sys
import termios
import threading
import time
import tty

import numpy as np

# xterm mouse reporting: button-event tracking (drag) + SGR extended coords
_MOUSE_ON = "\x1b[?1002h\x1b[?1006h"
_MOUSE_OFF = "\x1b[?1006l\x1b[?1002l"


# partially-received SGR mouse sequence carried across _read_events calls:
# terminal bytes can straddle the 10 ms per-byte select timeouts, and
# dropping the partial mid-stream made the leftover digits/';' bytes
# reappear as spurious key events on the next call (ADVICE r2)
_sgr_partial: str | None = None


def _read_events(timeout: float = 0.0) -> list[tuple]:
    """Non-blocking read of pending input events.

    Returns a list of ("key", ch), ("mouse", btn, x, y, is_press),
    ("drag", x, y) or ("scroll", direction) tuples. Arrow keys decode to
    ("key", "up"/"down"/"left"/"right"); SGR mouse sequences
    (ESC [ < b ; x ; y M/m) decode to drag/scroll events the way the
    reference's ControllerView NSEvent handlers would see them.
    """
    global _sgr_partial
    events: list[tuple] = []

    def read_sgr(seq: str) -> None:
        """Consume an SGR payload; stash the partial if bytes run dry."""
        global _sgr_partial
        while select.select([sys.stdin], [], [], 0.01)[0]:
            c = sys.stdin.read(1)
            if c in "Mm":
                _sgr_partial = None
                try:
                    btn_s, x_s, y_s = seq.split(";")
                    btn = int(btn_s)
                    x, y = int(x_s), int(y_s)
                except ValueError:
                    return
                if btn & 64:  # scroll wheel
                    events.append(("scroll", -1 if (btn & 3) == 0 else 1))
                elif btn & 32:  # motion with button held = drag
                    events.append(("drag", x, y))
                else:
                    events.append(("mouse", btn & 3, x, y, c == "M"))
                return
            seq += c
            if len(seq) > 32:  # malformed stream; stop buffering
                _sgr_partial = None
                return
        _sgr_partial = seq  # bytes straddled the timeout; resume next call

    if _sgr_partial is not None:
        read_sgr(_sgr_partial)
    while select.select([sys.stdin], [], [], timeout)[0]:
        timeout = 0.0
        ch = sys.stdin.read(1)
        if ch != "\x1b":
            events.append(("key", ch))
            continue
        if not select.select([sys.stdin], [], [], 0.01)[0]:
            events.append(("key", "esc"))
            continue
        ch2 = sys.stdin.read(1)
        if ch2 != "[":
            # ESC followed by a plain byte (alt-chords, pasted text): the
            # byte is a real keystroke, not part of a control sequence —
            # dropping it ate the key (tests/test_viewer_input.py)
            events.append(("key", "esc"))
            events.append(("key", "esc" if ch2 == "\x1b" else ch2))
            continue
        if not select.select([sys.stdin], [], [], 0.01)[0]:
            continue
        ch3 = sys.stdin.read(1)
        if ch3 in "ABCD":
            events.append(("key", {"A": "up", "B": "down", "C": "right",
                                   "D": "left"}[ch3]))
            continue
        if ch3 != "<":
            continue
        # SGR mouse: <btn>;<x>;<y>(M=press/motion | m=release)
        read_sgr("")
    return events


# one half-block cell, zero-padded fixed width so digit positions are
# static: the whole frame becomes a numpy byte-buffer fill (the per-pixel
# f-string loop cost ~300 ms/frame at 256x144; np.char ops still ~80 ms;
# this is ~2 ms)
_CELL = "\x1b[38;2;000;000;000m\x1b[48;2;000;000;000m▀".encode()
_ROW_SUFFIX = "\x1b[0m\n".encode()


def _cell_digit_positions() -> list[int]:
    pos, i = [], 0
    while True:
        i = _CELL.find(b"000", i)
        if i < 0:
            return pos
        pos.append(i)
        i += 3


_DIGIT_POS = _cell_digit_positions()  # 6 triplets: fg r,g,b then bg r,g,b
assert len(_DIGIT_POS) == 6


class _DisplayWriter:
    """Latest-wins terminal writer thread — true display decoupling.

    A 512x288 truecolor frame is ~3 MB of escape codes; a slow terminal
    or ssh pipe can take SECONDS to drain one (measured: pty writes
    stretching 80 ms mean, multi-second tail, while the device idles).
    The render loop therefore never touches the terminal: it `post()`s
    the raw u8 frame + status line and moves on. This thread builds the
    ANSI text (~17 ms of NumPy, off the render thread) and writes it;
    when the terminal falls behind, intermediate frames are dropped —
    progressive accumulation makes every displayed frame a strict
    refinement of the last, so drops cost smoothness, never content.
    (The reference gets the same decoupling from CAMetalLayer vsync
    presentation, `Window/ApplicationDelegate.cpp:39-41`.)
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._frame = None  # latest (img, status) — older posts are dropped
        self._texts: list[str] = []  # control messages, never dropped
        self._posted = 0
        self._written = 0
        self._stop = False
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def post(self, img, status: str) -> None:
        with self._cond:
            self._frame = (img, status)
            self._posted += 1
            self._cond.notify()

    def post_text(self, text: str) -> None:
        with self._cond:
            self._texts.append(text)
            self._cond.notify()

    def drain(self, timeout: float = 10.0) -> None:
        """Block until the latest posted frame has reached the terminal."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while (
                (self._posted != self._written or self._texts)
                and not self._stop
                and time.perf_counter() < deadline
            ):
                self._cond.wait(0.05)

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._th.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._cond:
                while (
                    self._frame is None and not self._texts
                    and not self._stop
                ):
                    self._cond.wait()
                if self._stop and self._frame is None and not self._texts:
                    return
                frame, self._frame = self._frame, None
                texts, self._texts = self._texts, []
                seq = self._posted
            try:
                if frame is not None:
                    img, status = frame
                    sys.stdout.write("\x1b[H" + _frame_to_ansi(img) + status)
                for t in texts:
                    sys.stdout.write(t)
                sys.stdout.flush()
            except (OSError, ValueError):
                return  # terminal gone — the render loop exits on quit/EOF
            with self._cond:
                self._written = seq
                self._cond.notify_all()


_srgb_u8_jit = None  # lazily-jitted (jax import is deferred in this module)


def _srgb_u8(state):
    """Resolve AccumState to sRGB uint8 ON DEVICE (jitted, one dispatch):
    the device-to-host copy then moves (H, W, 3) bytes per frame instead
    of f32, 4x less."""
    global _srgb_u8_jit
    if _srgb_u8_jit is None:
        import jax
        import jax.numpy as jnp

        def resolve(state):
            img = state.rgb_sum / jnp.maximum(state.spp, 1).astype(
                jnp.float32
            )
            img = jnp.clip(img, 0.0, 1.0)
            srgb = jnp.where(
                img <= 0.0031308, img * 12.92,
                1.055 * jnp.power(img, 1 / 2.4) - 0.055,
            )
            return (srgb * 255 + 0.5).astype(jnp.uint8)

        _srgb_u8_jit = jax.jit(resolve)
    return _srgb_u8_jit(state)


def _frame_to_ansi(img: np.ndarray) -> str:
    """(H, W, 3) linear [0,1] f32 OR pre-resolved sRGB uint8 (from
    `_srgb_u8`) → truecolor half-block string (H/2 rows)."""
    if img.dtype == np.uint8:
        rgb = img.astype(np.uint16)
    else:
        from metalpathtracer_tpu.io.png import linear_to_srgb

        rgb = (linear_to_srgb(img) * 255 + 0.5).astype(np.uint16)
    h = rgb.shape[0] & ~1
    w = rgb.shape[1]
    vals = np.concatenate([rgb[0:h:2], rgb[1:h:2]], axis=-1)  # (h/2, w, 6)

    buf = np.tile(
        np.frombuffer(_CELL, np.uint8), (h // 2, w, 1)
    )  # (h/2, w, cell_len)
    for k, p in enumerate(_DIGIT_POS):
        v = vals[..., k]
        buf[..., p] = v // 100 + 48
        buf[..., p + 1] = (v // 10) % 10 + 48
        buf[..., p + 2] = v % 10 + 48

    rows = buf.reshape(h // 2, w * len(_CELL))
    suffix = np.tile(np.frombuffer(_ROW_SUFFIX, np.uint8), (h // 2, 1))
    out = np.concatenate([rows, suffix], axis=1).tobytes()
    return out[:-1].decode("utf-8")  # drop the trailing newline


def run_viewer(scene_path: str, width: int = 512, height: int = 288,
               spp_per_frame: int = 1, max_depth: int = 8, seed: int = 0,
               max_frames: int | None = None, fit_terminal: bool = False,
               integrator: str = "wavefront",
               mouse: bool = True) -> None:
    import jax.numpy as jnp

    from metalpathtracer_tpu.io import write_png
    from metalpathtracer_tpu.render import (
        Camera,
        RenderConfig,
        accumulate,
        accumulate_wavefront,
        init_accum,
        to_image,
        upload_scene,
    )
    from metalpathtracer_tpu.render.camera import InputState, apply_inputs
    from metalpathtracer_tpu.scene import load_scene_xml

    scene = upload_scene(load_scene_xml(scene_path))
    cam = Camera.reset()
    # bounces per regeneration cycle: 1 (the bench's setting); env
    # override for interactive-latency sweeps
    cfg = RenderConfig(
        max_depth=max_depth,
        bounces_per_iter=int(os.environ.get("MPT_VIEWER_BPI", "1")),
    )
    state = init_accum(width, height)
    inputs = InputState()
    use_wavefront = integrator == "wavefront"

    def terminal_render_size():
        try:
            cols, rows = os.get_terminal_size()
        except OSError:
            return width, height
        return max(16, cols), max(16, 2 * (rows - 1))

    if fit_terminal:
        width, height = terminal_render_size()
        state = init_accum(width, height)

    def drag_scale(w):
        # one full image-width drag sweeps ~half a turn, like dragging
        # across the reference's window (rotate speed lives in apply_inputs)
        return 1600.0 / max(w, 1)

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J")  # clear
    if mouse:
        sys.stdout.write(_MOUSE_ON)
        sys.stdout.flush()
    frames = 0
    drag_last: tuple[int, int] | None = None
    display = _DisplayWriter()  # terminal IO never blocks the render loop
    # Deep software pipeline (VERDICT r4 #8): progressive accumulation is
    # a DEVICE-SIDE chain — state N+1 = f(state N) needs no host value —
    # so the loop keeps `pipe_depth` accumulate steps queued ahead and
    # displays from the queue head. Dispatch latency and the frame-sized
    # u8 image fetch then hide behind in-flight device work instead of
    # serializing with it. The chain was built for a high dispatch
    # latency; whether it still pays on the GPU is not measured. Input
    # latency stays one frame: a camera change clears the
    # queue (those frames used the stale camera, exactly the accumulation
    # the reference also throws away, Renderer.cpp:255-257) and restarts
    # the chain, so the next DISPLAYED frame is new-camera.
    pipe_depth = max(1, int(os.environ.get("MPT_VIEWER_PIPE", "3")))
    if not use_wavefront:
        pipe_depth = 1
    # queue entries: (accum_state, rays, u8 image on device, host spp).
    # accumulate/accumulate_wavefront DONATE the input state (pipeline.py
    # donate_argnums), so a queued state's buffers are dead the moment the
    # NEXT chain step dispatches — only `chain` (the newest, not yet
    # donated) may be read on the host; displayed frames read the u8
    # image (a fresh, undonated output) and the host-side spp counter.
    queue: list = []
    chain = state  # newest dispatched accumulation state
    chain_spp = int(state.spp)  # host-side mirror (device spp is donated)

    def reset_chain(new_state):
        nonlocal chain, queue, chain_spp
        queue = []
        chain = new_state
        chain_spp = 0

    try:
        while max_frames is None or frames < max_frames:
            # resize → rebuild accumulation at the new size AND reset the
            # sample counter (the reference forgets the reset and averages
            # against uninitialized textures — SURVEY.md appendix 8)
            if fit_terminal:
                new_w, new_h = terminal_render_size()
                if (new_w, new_h) != (width, height):
                    width, height = new_w, new_h
                    reset_chain(init_accum(width, height))
                    display.post_text("\x1b[2J")

            # --- keep the device fed: queue progressive steps ahead ------
            t0 = time.perf_counter()
            while len(queue) < pipe_depth:
                if use_wavefront:
                    # small pool: a viewer frame is ~1 spp of a small
                    # image, so drain-stage count (and compile size)
                    # stays low. MPT_VIEWER_POOL (log2) for sweeps.
                    nxt, rays_n = accumulate_wavefront(
                        chain, scene, cam, width, height, spp_per_frame,
                        jnp.uint32(seed), cfg,
                        pool_size=min(
                            1 << int(os.environ.get("MPT_VIEWER_POOL",
                                                    "14")),
                            width * height * spp_per_frame,
                        ),
                    )
                else:
                    nxt = accumulate(
                        chain, scene, cam, width, height, spp_per_frame,
                        jnp.uint32(seed), cfg,
                    )
                    rays_n = None
                # device-side sRGB resolve queued with the step: the
                # fetch moves uint8, 4x less than the f32 image
                # (to_image stays for PNG saves)
                img_u8 = _srgb_u8(nxt)
                try:
                    # start the device->host copies NOW (dependency-ordered
                    # behind the render): by the time this frame reaches
                    # the queue head, the transfer has already
                    # overlapped newer frames' device work. The ray-count
                    # scalar rides along — otherwise the status line's
                    # int(rays) pays a blocking round trip per frame
                    img_u8.copy_to_host_async()
                    if rays_n is not None:
                        rays_n.copy_to_host_async()
                except (AttributeError, RuntimeError):
                    pass
                chain_spp += spp_per_frame
                queue.append((nxt, rays_n, img_u8, chain_spp))
                chain = nxt
            pending, rays, img_dev, shown_spp = queue[0]
            # fetch the head in a worker thread (device_get releases the
            # GIL), so input polling overlaps the residual transfer
            fetch_box: list = []
            fetch_th = threading.Thread(
                target=lambda a=img_dev: fetch_box.append(np.asarray(a)),
                daemon=True,
            )
            fetch_th.start()
            t_disp = time.perf_counter()

            # --- input → camera while the device renders (§3.3, now with
            # the reference's mouse modality: drag=rotate, wheel=zoom) -----
            quit_req = False
            save_req = False
            while True:
                for ev in _read_events():
                    kind = ev[0]
                    if kind == "key":
                        k = ev[1]
                        if k == "q":
                            quit_req = True
                        elif k == "w":
                            inputs.movement = np.array([0, 0, 1], np.float32)
                        elif k == "s":
                            inputs.movement = np.array([0, 0, -1], np.float32)
                        elif k == "a":
                            inputs.movement = np.array([-1, 0, 0], np.float32)
                        elif k == "d":
                            inputs.movement = np.array([1, 0, 0], np.float32)
                        elif k == " ":
                            inputs.movement = np.array([0, 1, 0], np.float32)
                        elif k == "c":
                            inputs.movement = np.array([0, -1, 0], np.float32)
                        elif k == "left":
                            inputs.rotation = inputs.rotation + np.array(
                                [-40.0, 0], np.float32
                            )
                        elif k == "right":
                            inputs.rotation = inputs.rotation + np.array(
                                [40.0, 0], np.float32
                            )
                        elif k == "up":
                            inputs.rotation = inputs.rotation + np.array(
                                [0, -40.0], np.float32
                            )
                        elif k == "down":
                            inputs.rotation = inputs.rotation + np.array(
                                [0, 40.0], np.float32
                            )
                        elif k == "+":
                            inputs.zoom = -20.0
                        elif k == "-":
                            inputs.zoom = 20.0
                        elif k == "r":
                            inputs.reset = True
                        elif k == "p":
                            save_req = True
                    elif kind == "mouse":
                        _, btn, x, y, press = ev
                        drag_last = (x, y) if press and btn == 0 else None
                    elif kind == "drag":
                        _, x, y = ev
                        if drag_last is not None:
                            s = drag_scale(width)
                            dx = (x - drag_last[0]) * s
                            dy = (y - drag_last[1]) * 2 * s  # half-block rows
                            inputs.rotation = inputs.rotation + np.array(
                                [dx, dy], np.float32
                            )
                        drag_last = (x, y)
                    elif kind == "scroll":
                        inputs.zoom += 12.0 * ev[1]
                if quit_req or not fetch_th.is_alive():
                    break
                time.sleep(0.002)
            if quit_req:
                return

            t_poll = time.perf_counter()
            queue.pop(0)
            fetch_th.join()
            img = fetch_box[0]
            dt = time.perf_counter() - t0
            if os.environ.get("MPT_VIEWER_TRACE"):
                print(
                    f"frame {frames}: dispatch {t_disp - t0:.3f}s "
                    f"write 0.000s "
                    f"poll {t_poll - t_disp:.3f}s "
                    f"fetch {time.perf_counter() - t_poll:.3f}s "
                    f"dt {dt:.3f}s",
                    file=sys.stderr,
                )

            if save_req:
                os.makedirs("runs", exist_ok=True)
                out = f"runs/viewer_{int(time.time())}.png"
                # save from `chain`, the newest state — the only one whose
                # buffers are still live under donation (and the most spp)
                write_png(out, np.asarray(to_image(chain)))
                display.post_text(f"\x1b[H\x1b[2Ksaved {out}\n")

            # --- apply the inputs gathered during the render --------------
            cam, changed = apply_inputs(cam, inputs)
            inputs.movement = np.zeros(3, np.float32)
            inputs.clear()
            if changed:
                # accumulation invalidation (reference Renderer.cpp:255-257)
                # — also drops the queued in-flight frames, which used the
                # stale camera; the next displayed frame is new-camera
                reset_chain(init_accum(width, height))

            mrays = (
                f" | {int(rays) / dt / 1e6:6.2f} Mrays/s" if rays is not None
                else ""
            )
            display.post(
                img,
                f"\n\x1b[0m\x1b[2K{shown_spp} spp | "
                f"{1.0 / max(dt, 1e-9):5.1f} fps{mrays} | "
                f"drag rotate, wheel zoom, wasd/space/c move, +/- fov, "
                f"r reset, p png, q quit",
            )
            frames += 1
        display.drain()  # the final frame must reach the terminal
    finally:
        display.stop()
        if mouse:
            sys.stdout.write(_MOUSE_OFF)
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="interactive terminal viewer")
    p.add_argument("--scene", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--spp-per-frame", type=int, default=1)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None,
                   help="exit after N frames (for testing)")
    p.add_argument("--fit-terminal", action="store_true",
                   help="track the terminal size (resize resets accumulation)")
    p.add_argument("--integrator", choices=("wavefront", "scan"),
                   default="wavefront")
    p.add_argument("--no-mouse", action="store_true",
                   help="skip xterm mouse reporting")
    a = p.parse_args(argv)
    from metalpathtracer_tpu.utils import enable_persistent_compile_cache

    # a fresh viewer process otherwise pays the full remote XLA compile
    # (~5 min at 512x288) before the first frame appears
    enable_persistent_compile_cache()
    run_viewer(a.scene, a.width, a.height, a.spp_per_frame, a.max_depth,
               a.seed, a.max_frames, a.fit_terminal, a.integrator,
               mouse=not a.no_mouse)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
