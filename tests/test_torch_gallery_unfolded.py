"""The gallery's unfolded demos on the port, run in-process on the CPU at
their fast sizes (fewer steps), each held to the claim its JAX demo prints,
or, where the claim needs the full number of steps, to its training loss
falling (see ``tests/test_torch_gallery_basics.py``; the full claims are
held on the card by ``chip_smoke.py``). The JAX demos printed, on the CPU:
MoDL's train PSNR 13.55 -> 19.56 dB over 5 epochs; the DEQ 19.85 against
15.86 dB; LISTA's loss 0.03036 -> 0.02444; remat's gradient difference 0;
learned PD 23.49 against the FBP's 19.10 dB; the unfolded network's test
PSNR 16.20 -> 20.99 dB; the smooth-TV network's 19.38 -> 21.39 dB; the
constrained CP's 17.65 dB.
"""

import importlib

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)


def demo(name):
    return importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")


def test_unfolded_mri():
    """One epoch of MoDL lifts the PSNR on the training measurements."""
    out = demo("unfolded_mri").main(device="cpu", fast=True)
    assert out["psnr_after"] > out["psnr_before"] + 1


def test_deq():
    """The DEQ's training loss falls at every step through the implicit
    backward, and the trained equilibrium beats the measurement."""
    out = demo("deq").main(device="cpu", fast=True)
    assert all(b < a for a, b in zip(out["losses"], out["losses"][1:]))
    assert out["psnr_xhat"] > out["psnr_y"]


def test_lista():
    """Training the stepsizes and thresholds lowers the loss (asserted in
    JAX)."""
    out = demo("lista").main(device="cpu", fast=True)
    assert out["losses"][-1] < out["losses"][0]


def test_unfolded_constant_memory():
    """``remat`` changes the memory, not the gradient: within 1e-4 (asserted
    in JAX); on the CPU the same bits."""
    out = demo("unfolded_constant_memory").main(device="cpu", fast=True)
    assert out["max_grad_difference"] == 0.0 and out["max_grad_rel_difference"] == 0.0


def test_learned_primal_dual():
    """PDNet's training loss falls by more than half in 10 steps."""
    out = demo("learned_primal_dual").main(device="cpu", fast=True)
    assert out["final_loss"] < 0.5 * out["first_loss"]


def test_vanilla_unfolded():
    """Training the schedule and the DnCNN together lifts the test PSNR."""
    out = demo("vanilla_unfolded").main(device="cpu", fast=True)
    assert out["psnr_final"] > out["psnr_initial"] + 1
    assert len(out["stepsize"]) == 5 and out["stepsize"] != [1.0] * 5


def test_custom_prior_unfolded():
    """Learning only the stepsizes and lambdas lifts the test PSNR."""
    out = demo("custom_prior_unfolded").main(device="cpu", fast=True)
    assert out["psnr_after"] > out["psnr_before"]
    assert len(out["stepsize"]) == len(out["lambda"]) == 10


def test_unfolded_constrained_lista():
    """The trained constrained CP beats the zero fill (asserted in JAX)."""
    out = demo("unfolded_constrained_lista").main(device="cpu", fast=True)
    assert out["psnr_xhat"] > out["psnr_zero_fill"]
    assert out["max_residual"] > 0 and out["radius"] > 0
