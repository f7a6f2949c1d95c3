"""Deep GP trained with doubly-stochastic variational inference (DSVI).

Counterpart of ``nonstationary_precip_tpu/models/deep_gp.py``: whitened SVGP
hidden layers (width 2, linear means) and a scalar SVGP head (constant mean)
under a Gaussian likelihood, trained on the DSVI ELBO with S marginal
samples propagated through the stack:

  ELBO/datum = mean_S mean_B E_{q(f_L)}[log N(y | f_L, σ²)] − Σ_layers KL / N

with the closed-form Gaussian expected log-likelihood
E[log N(y|f,σ²)] = log N(y|μ,σ²) − var/(2σ²).

Randomness comes from the caller: ``loss``, ``propagate`` and ``predict``
take ε as one (..., S, O, B) tensor per hidden layer, where the JAX package
draws it inside from a key.  Leading batch axes (the split axis of a
stacked model) pass through.  Layers are distinct by default;
``share_hidden=True`` reapplies one hidden layer, with one KL, as the
reference does.  ``loss`` takes the fused data term (K7,
``ops/elbo_fused.py``) where its gate admits the model and the batch, as
the JAX package's ``_fused_loss`` does; ``full_cov=True`` propagates
batch-correlated samples from each hidden layer's joint instead (the
reference's rsample from the joint), never through the fused term.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from nonstationary_precip_tpu_torch.models.distributions import DiagNormal
from nonstationary_precip_tpu_torch.models.likelihoods import GaussianLikelihood
from nonstationary_precip_tpu_torch.models.svgp import SVGPLayer, precompute_inputs, precompute_layers
from nonstationary_precip_tpu_torch.ops import elbo_fused
from nonstationary_precip_tpu_torch.ops.svgp_precompute import svgp_precompute_fused

NUM_OUTPUT_DIMS = 2  # reference module constant, dgps.py:13


class DeepGP(nn.Module):
    """Hidden layers (Din→2→…→2, linear means) and a scalar head (constant mean)."""

    def __init__(self, layers: Sequence[SVGPLayer], head: SVGPLayer, likelihood: GaussianLikelihood,
                 share_hidden: bool = False, num_layers: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.head = head
        self.likelihood = likelihood
        self.share_hidden = share_hidden
        self.num_layers = num_layers

    @classmethod
    def create(cls, generator: torch.Generator, input_dims: int, num_layers: int = 2, num_inducing: int = 250,
               hidden_dims: int = NUM_OUTPUT_DIMS, share_hidden: bool = False, dtype=torch.float32, device=None):
        """Layers in order, then the head, each drawing its z from
        ``generator``."""
        def layer(din, dout, mean_type):
            return SVGPLayer.create(generator, din, dout, num_inducing, mean_type, dtype, device)

        if share_hidden:
            if input_dims != hidden_dims:
                raise ValueError("share_hidden requires input_dims == hidden_dims "
                                 "(the reference reapplies one 2→2 layer)")
            layers = [layer(input_dims, hidden_dims, "linear")]
        else:
            dims = [input_dims] + [hidden_dims] * num_layers
            layers = [layer(dims[i], dims[i + 1], "linear") for i in range(num_layers)]
        head = layer(hidden_dims, 1, "constant")
        return cls(layers, head, GaussianLikelihood.create(dtype=dtype, device=device),
                   share_hidden=share_hidden, num_layers=num_layers)

    def _hidden_stack(self):
        if self.share_hidden:
            return [self.layers[0]] * self.num_layers
        return list(self.layers)

    # -- forward -----------------------------------------------------------------

    def propagate(self, x: torch.Tensor, eps: Sequence[torch.Tensor], *, full_cov: bool = False):
        """Push S samples through the stack.  x (..., B, Din); eps holds one
        (..., S, O, B) standard-normal tensor per hidden layer, the draws the
        JAX package makes for that layer in either mode.  ``full_cov=False``
        propagates marginal samples (all the ELBO needs); ``full_cov=True``
        samples every hidden layer from its joint over the batch
        (``SVGPLayer.sample_joint``, a B × B Cholesky per output and
        sample).  The first layer's joint does not depend on the sample and
        is factored once.  Returns the head's marginals per sample: (mean,
        var), each (..., S, B)."""
        stack = self._hidden_stack()
        if len(eps) != len(stack) or not stack:
            raise ValueError(f"propagate: {len(stack)} hidden layers need as many ε tensors, got {len(eps)}")
        # the K_zz factors are sample-independent: every layer's come from
        # one K4 call over the concatenated stack
        pre_uniq = precompute_layers(list(self.layers) + [self.head])
        pre = [pre_uniq[0]] * len(stack) if self.share_hidden else pre_uniq[:-1]

        if full_cov:
            h = x
            for layer, layer_pre, e in zip(stack, pre, eps):
                h = layer.sample_joint(h, e, layer_pre)  # (.., S, B, O)
        else:
            # the first layer's input is the same for every sample: its
            # marginals are computed once, outside the sample axis
            m1, v1 = stack[0].marginals(x, pre[0])  # (.., O, B)
            h = (m1[..., None, :, :] + torch.sqrt(v1)[..., None, :, :] * eps[0]).mT  # (.., S, B, O)
            for layer, layer_pre, e in zip(stack[1:], pre[1:], eps[1:]):
                h = layer.sample(h, e, layer_pre)
        mean, var = self.head.marginals(h, pre_uniq[-1])  # (.., S, 1, B)
        return mean[..., 0, :], var[..., 0, :]

    # -- objective ---------------------------------------------------------------

    def _fused_ineligible(self, x, y, eps, any_float: bool):
        """Why the fused data term does not take this model and batch, or None
        where it does: the JAX ``_fused_loss``'s topology checks, then
        ``elbo_fused.ineligible``."""
        if self.share_hidden or self.num_layers != 2 or len(self.layers) != 2:
            return "the fused data term takes 2 distinct hidden layers"
        l1, l2, hd = self.layers[0], self.layers[1], self.head
        if (l1.mean_type, l2.mean_type, hd.mean_type) != ("linear", "linear", "constant"):
            return "the fused data term takes linear hidden means and a constant head mean"
        lead, b = l1.var_mean.shape[:-2], x.shape[-2]
        if (x.shape[:-2] != lead or y.shape != (*lead, b) or len(eps) != 2
                or any(e.shape[:-3] != lead or e.shape[-2:] != (2, b) or e.shape[-3] != eps[0].shape[-3]
                       for e in eps)):
            return "the fused data term takes x, y and ε with the model's batch axes and one S"
        return elbo_fused.ineligible(x, l1.z.shape, l2.z.shape, hd.z.shape, any_float=any_float)

    def elbo_params(self):
        """The fused data term's parameters (``ops/elbo_fused.py``'s layout,
        batch axes folded into the member axis T), W from one K4 call over
        the three layers: the counterpart of the packing in the JAX
        ``_fused_loss``."""
        l1, l2, hd = self.layers[0], self.layers[1], self.head
        z, ell, s2, packed = precompute_inputs([l1, l2, hd])
        _, w, _ = svgp_precompute_fused(z, ell, s2, packed)
        m = z.shape[-2]
        t = z.shape[0] // 5
        return {"z": z.reshape(t, 5, m, 2), "ell": ell.reshape(t, 5, 2), "s2": s2.reshape(t, 5),
                "w": w.reshape(t, 5, m, w.shape[-1]), "mw1": l1.mean_w.reshape(t, 2, 2),
                "mb1": l1.mean_b.reshape(t, 2), "mw2": l2.mean_w.reshape(t, 2, 2), "mb2": l2.mean_b.reshape(t, 2),
                "mbh": hd.mean_b.reshape(t, 1)}

    def _fused_loss(self, x, y, num_data: int, eps):
        params = self.elbo_params()
        t = params["z"].shape[0]
        lead, b = self.layers[0].var_mean.shape[:-2], x.shape[-2]
        s = eps[0].shape[-3]
        data_term = elbo_fused.fused_data_term(
            x.reshape(t, b, 2).contiguous(), y.reshape(t, b).contiguous(),
            *(e.reshape(t, s, 2, b).contiguous() for e in eps), params,
            self.likelihood.noise.reshape(t).contiguous())
        kl = self.head.kl() + self.layers[0].kl() + self.layers[1].kl()
        return -(data_term.reshape(lead) - kl / num_data)

    def loss(self, x, y, num_data: int, eps: Sequence[torch.Tensor], *, full_cov: bool = False, fused_elbo=None):
        """−ELBO per datum, one per batch entry; num_data is the full
        training-set N for the KL scaling.

        ``fused_elbo``: None takes the fused data term (K7: the kernels on
        the card, the plain version on the CPU) wherever its gate admits the
        call, float32 only, and the composed path elsewhere, as the JAX
        gate does; True takes the fused term or raises outside the gate (on
        the CPU any float dtype, for checks in float64); False takes the
        composed path."""
        if not full_cov and fused_elbo is not False:
            reason = self._fused_ineligible(x, y, eps, any_float=fused_elbo is True and x.device.type == "cpu")
            if reason is None:
                return self._fused_loss(x, y, num_data, eps)
            if fused_elbo:
                raise ValueError(f"DeepGP.loss(fused_elbo=True): {reason}")
        means, variances = self.propagate(x, eps, full_cov=full_cov)
        noise = self.likelihood.noise[..., None, None]
        ell = -0.5 * (torch.log(2.0 * math.pi * noise) + ((y[..., None, :] - means) ** 2 + variances) / noise)
        data_term = torch.mean(torch.mean(ell, dim=-1), dim=-1)
        if self.share_hidden:
            # tied layers contribute one KL: one q(u) exists
            kl = self.head.kl() + self.layers[0].kl()
        else:
            kl = self.head.kl()
            for layer in self._hidden_stack():
                kl = kl + layer.kl()
        return -(data_term - kl / num_data)

    # -- prediction ---------------------------------------------------------------

    def predict(self, x, eps: Sequence[torch.Tensor]):
        """Predictive mixture over the S sample paths, with observation noise.
        Returns (mixture DiagNormal (..., B), per-sample means (..., S, B),
        per-sample variances (..., S, B))."""
        means, variances = self.propagate(x, eps)
        variances = variances + self.likelihood.noise[..., None, None]
        mix_mean = torch.mean(means, dim=-2)
        mix_var = torch.mean(variances + means**2, dim=-2) - mix_mean**2
        return DiagNormal(mix_mean, mix_var), means, variances
