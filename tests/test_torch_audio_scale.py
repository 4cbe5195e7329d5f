"""The port's twin of ``tests/test_audio_scale.py``: the generated 50k-sample
audio-like signal, ``itd_sift(x, 11)`` in f64 on the CPU against the numpy
oracle ``reference.itd_ref`` to 1e-10, and its reconstruction to 1e-10."""
import numpy as np
import torch

from pyitd_tpu_torch import itd_sift, neumaier_sum
from pyitd_tpu_torch.utils.interop import from_numpy
from reference.itd_ref import itd_sift as ref_sift
from test_audio_scale import audio_like

torch.set_num_threads(1)


def test_audio_scale_parity_and_reconstruction():
    x = audio_like()
    res = itd_sift(from_numpy(x), 11)
    assert res.rotations.dtype == torch.float64
    n = int(res.num_components)
    want, _ = ref_sift(x, 11)
    assert n == want.shape[0]
    np.testing.assert_allclose(res.rotations[:n].numpy(), want, atol=1e-10,
                               rtol=0)
    err = float((neumaier_sum(res.rotations[:n]) - torch.from_numpy(x))
                .abs().max())
    assert err < 1e-10, err
