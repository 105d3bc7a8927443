"""The port on an NVIDIA GPU: the CUDA payload kernel against its plain
PyTorch version, and the decode on the card against the decode on the
CPU.  Every test here is marked ``cuda`` and skips without a GPU.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch import Modulation
from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.kernels import payload_fused as pf
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.pipeline import report, rx
import torch_oracle as oracle

pytestmark = pytest.mark.cuda


def _tail_case(dev, M, cp, n_sym):
    p_re, p_im, G = oracle.random_tail_inputs(M + n_sym, 2, M, cp, n_sym)
    W, gain = zf.invert(torch.as_tensor(G, device=dev))
    args = (torch.as_tensor(p_re, device=dev),
            torch.as_tensor(p_im, device=dev), W, gain,
            constellation.table(Modulation.ARB32OPT),
            np.float32(1.0 / np.sqrt(M)))
    return args, dict(n_sym=n_sym, symbol_len=M + cp, cp_len=cp)


@pytest.mark.parametrize("M,cp,n_sym", [(2048, 152, 13), (64, 16, 8),
                                        (1024, 72, 5), (4096, 288, 3)])
def test_kernel_matches_plain_tail(M, cp, n_sym):
    dev = oracle.require_cuda()
    args, kw = _tail_case(dev, M, cp, n_sym)
    before = pf.payload_fused_strip.launches
    sig, data = pf.payload_fused_strip(*args, **kw)
    ref_sig, ref_data = pf.payload_tail_reference(*args, **kw)
    torch.cuda.synchronize()
    assert pf.payload_fused_strip.launches == before + 1
    assert data.dtype == torch.int32 and data.shape == ref_data.shape
    assert int((data != ref_data).sum()) == 0
    rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
    assert float((sig - ref_sig).abs().max()) <= 1e-4 * rms
    _, data_only = pf.payload_fused_strip(*args, emit_sig=False, **kw)
    assert torch.equal(data_only, data)


def test_kernel_rejects_what_it_cannot_take():
    dev = oracle.require_cuda()
    args, kw = _tail_case(dev, 64, 16, 4)
    p_re, p_im, W, gain, tab, norm = args
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re.double(), p_im, W, gain, tab, norm, **kw)
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re.cpu(), p_im, W, gain, tab, norm, **kw)
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re, p_im, W, gain,
                               constellation.table(Modulation.QAM256), norm,
                               **kw)


@pytest.mark.parametrize("cfg", [oracle.TINY, oracle.MID],
                         ids=["tiny", "mid"])
def test_decode_on_card_matches_cpu(cfg):
    dev = oracle.require_cuda()
    spec = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3)
    cap, tx, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    on_cpu = rx.make_decoder(cfg, device="cpu")(cap)
    before = pf.payload_fused_strip.launches
    on_card = rx.make_decoder(cfg, device=dev, input_format="planes")(
        cap.real.contiguous(), cap.imag.contiguous())
    assert pf.payload_fused_strip.launches == before + 1
    for f in ("synced", "sync_index", "sync_sample", "plateau_start",
              "s0_index", "ac_index", "decode_start", "rx_data",
              "symbol_valid"):
        np.testing.assert_array_equal(oracle.n(getattr(on_card, f)),
                                      oracle.n(getattr(on_cpu, f)),
                                      err_msg=f)
    np.testing.assert_allclose(oracle.n(on_card.G), oracle.n(on_cpu.G),
                               rtol=1e-4, atol=1e-6)
    assert report.score(on_card, tx, cfg).symbol_error_rate == [0.0, 0.0]
