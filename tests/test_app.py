import os
import time

import jax.numpy as jnp
import numpy as np

from vulkan_pbr_renderer.app.camera import FpsCamera
from vulkan_pbr_renderer.app.hotreload import ShaderWatcher
from vulkan_pbr_renderer.config import RenderConfig


def test_fps_camera_default_faces_plus_y():
    """camera.h:45: zero pitch/yaw looks along +Y with Z up."""
    cam = FpsCamera(pos=np.array([0.0, 0.0, 2.0], np.float32))
    cam.update(0.016)
    cfg = RenderConfig(width=64, height=64)
    st = cam.matrices(cfg)
    # a point ahead on +Y projects to the screen centre
    p = jnp.array([0.0, 10.0, 2.0, 1.0])
    clip = st.clip_from_world @ p
    ndc = np.asarray(clip[:3] / clip[3])
    np.testing.assert_allclose(ndc[:2], 0.0, atol=1e-5)
    assert 0.0 < ndc[2] < 1.0


def test_fps_camera_movement_conventions():
    """W moves along view forward; Shift x3 (camera.h:67-92)."""
    cam = FpsCamera(pos=np.zeros(3, np.float32))
    cam.update(1.0, move=(1.0, 0.0, 0.0), speed=1.0)
    assert cam.pos[1] > 0.5 and abs(cam.pos[0]) < 1e-5  # moved toward +Y
    y1 = cam.pos[1]
    cam2 = FpsCamera(pos=np.zeros(3, np.float32))
    cam2.update(1.0, move=(1.0, 0.0, 0.0), speed=1.0, shift=True)
    assert cam2.pos[1] > y1 * 2.5  # Shift speeds up 3x


def test_fps_camera_lazy_smoothing():
    """camera.h:95-96: lazy pos lerps at 0.2 toward the target."""
    cam = FpsCamera(pos=np.zeros(3, np.float32))
    cam.update(0.016)  # initializes lazy state
    cam.pos = np.array([1.0, 0.0, 0.0], np.float32)
    cam.update(0.016)
    assert abs(cam.lazy_pos[0] - 0.2) < 1e-5


def test_fps_camera_mouse_look():
    cam = FpsCamera(pos=np.zeros(3, np.float32))
    cam.update(0.016, mouse=(100.0, 0.0), mouse_speed=0.002)
    assert abs(cam.yaw + 0.2) < 1e-6  # yaw -= mouse_speed * dx


def test_shader_watcher_detects_change(tmp_path):
    import sys
    import importlib

    mod_path = tmp_path / "fake_shade_mod.py"
    mod_path.write_text("VALUE = 1\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import fake_shade_mod  # noqa: F401

        watcher = ShaderWatcher(prefix="fake_shade_mod")
        assert watcher.poll() is False  # no change yet
        time.sleep(0.05)
        mod_path.write_text("VALUE = 2\n")
        os.utime(mod_path, (time.time() + 2, time.time() + 2))
        assert watcher.poll() is True
        assert sys.modules["fake_shade_mod"].VALUE == 2
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("fake_shade_mod", None)


def test_init_devices_retries(monkeypatch):
    """SURVEY §5 failure plan: transient backend-init failures retry."""
    import jax

    from vulkan_pbr_renderer.gpu import device

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient init failure")
        return ["dev0"]

    monkeypatch.setattr(jax, "devices", flaky)
    assert device.init_devices(retries=3, delay_s=0.0) == ["dev0"]
    assert calls["n"] == 3
    calls["n"] = -99  # always fails from here (< 3 forever)
    import pytest as _pytest

    with _pytest.raises(RuntimeError, match="after 2 attempts"):
        device.init_devices(retries=2, delay_s=0.0)
