"""The port's ResNet-34 feature extractor (``models/resnet.py``) against
the JAX package's ``resnet34_features`` at ``random_state_dict(0)``, at
JAX's tolerances (tests/test_resnet.py:88-139): the ``layer4_2``,
``avgpool_512`` and ``fc`` taps, the pre-ReLU tap, the layer table's
shapes and an unknown name. Also ``python -m
multimodalgame_tpu_torch.package_data`` on a tiny ImageFolder against
``tools/package_data.py``'s HDF5 (PIL and h5py needed)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalgame_tpu.models import resnet as jax_resnet
from multimodalgame_tpu_torch.models.resnet import (LAYER_NAMES,
                                                    params_from_torch_state,
                                                    random_state_dict,
                                                    resnet34_features)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-3, 1e-3


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 3, 227, 227) * 0.25).astype(np.float32)


@pytest.fixture(scope="module")
def both(images):
    """Every name of the layer table from both packages."""
    sd = random_state_dict(0)
    got = resnet34_features(params_from_torch_state(sd, "cpu"),
                            torch.from_numpy(images), LAYER_NAMES)
    want = jax_resnet.resnet34_features(
        jax_resnet.params_from_torch_state(sd), jnp.asarray(images),
        LAYER_NAMES)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def test_random_state_dict_is_jaxs():
    got, want = random_state_dict(0), jax_resnet.random_state_dict(0)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["layer4_2", "avgpool_512", "fc"])
def test_taps_match_jax(both, name):
    got, want = both
    np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL)


def test_layer_table_matches_jax(both):
    """Every name, in shape and value; spatial outputs NCHW."""
    got, want = both
    assert set(got) == set(want) == set(LAYER_NAMES)
    for name in LAYER_NAMES:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert got["bn1"].shape == (2, 64, 114, 114)
    assert got["maxpool"].shape == (2, 64, 57, 57)
    assert got["layer2"].shape == (2, 128, 29, 29)
    assert got["layer3"].shape == (2, 256, 15, 15)
    assert got["layer4_0_relu"].shape == (2, 512, 8, 8)
    assert got["avgpool"].shape == (2, 512, 1, 1)


def test_layer4_2_is_pre_relu(both):
    got, _ = both
    l42 = got["layer4_2"]
    assert l42.shape == (2, 512, 8, 8)
    assert (l42 < 0).any()
    np.testing.assert_allclose(np.maximum(l42, 0), got["layer4_2_relu"],
                               atol=1e-6)
    np.testing.assert_allclose(got["layer4_2_relu"].mean(axis=(2, 3)),
                               got["avgpool_512"], rtol=1e-4, atol=1e-5)


def test_unknown_request_raises(images):
    params = params_from_torch_state(random_state_dict(0))
    with pytest.raises(KeyError, match="nope"):
        resnet34_features(params, torch.from_numpy(images[:1]), ("nope",))


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    pytest.importorskip("PIL")
    pytest.importorskip("h5py")
    from PIL import Image
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for cls in ("hen", "koala"):
        (root / cls).mkdir()
        for i in range(3):
            arr = rng.randint(0, 255, (300, 240, 3), dtype=np.uint8)
            Image.fromarray(arr).save(str(root / cls / f"img{i}.jpg"))
    # An unreadable file, skipped (utils/package_data.py:198-208).
    (root / "hen" / "broken.jpg").write_bytes(b"not an image")
    return root


def test_package_data_matches_the_jax_tool(image_tree, tmp_path):
    import h5py
    desc = tmp_path / "descriptions.csv"
    desc.write_text("0,hen,adult female bird\n1,koala,sluggish tailless "
                    "marsupial\n")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import package_data as jax_tool
    finally:
        sys.path.pop(0)
    flags = ["-load_imgs", str(image_tree), "-load_desc", str(desc),
             "-batch_size", "4"]
    jax_tool.main(flags + ["-save_hdf5", str(tmp_path / "jax.hdf5")])
    # The port's CLI, as a user runs it (on the CPU here: its main takes
    # the device; python -m runs on the card).
    from multimodalgame_tpu_torch.package_data import main
    main(flags + ["-save_hdf5", str(tmp_path / "port.hdf5")], device="cpu")
    with h5py.File(tmp_path / "port.hdf5") as got, \
            h5py.File(tmp_path / "jax.hdf5") as want:
        assert set(got) == set(want) == {"Target", "Location", "layer4_2",
                                         "avgpool_512", "fc"}
        np.testing.assert_array_equal(got["Target"][:], want["Target"][:])
        assert got["Target"].dtype == want["Target"].dtype
        np.testing.assert_array_equal(got["Location"][:],
                                      want["Location"][:])
        assert got["Location"].dtype == want["Location"].dtype
        for k in ("layer4_2", "avgpool_512", "fc"):
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k][:], want[k][:], rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def test_package_data_module_has_the_tools_flags():
    out = subprocess.run(
        [sys.executable, "-m", "multimodalgame_tpu_torch.package_data",
         "-h"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("-load_desc", "-load_imgs", "-save_hdf5", "-batch_size",
                 "-request", "-weights"):
        assert flag in out.stdout, flag
