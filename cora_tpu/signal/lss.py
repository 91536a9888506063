"""The large-scale-structure simulation pipeline.

Re-design of the reference ``cora/signal/lss.py``: a chain of pipeline
tasks that transforms a matter power spectrum into biased, dynamically
evolved 21cm sky maps:

CalculateCorrelations → CalculateMultiFrequencyAngularPowerSpectrum →
GenerateInitialLSSFromCl → bias tasks → Zel'dovich/linear dynamics →
FingersOfGod → shot noise → BiasedLSSToMap.

The MPI axis redistributions of the reference (lss.py:441-474, 806-811,
1202 …) disappear: the hot stages (C_l quadrature, correlated a_lm draw +
SHT, spin-1 gradients, SPH scatter-add, FoG matmuls) are jitted device
programs over whole arrays, shardable via cora_tpu.parallel.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants
from ..cosmology import Cosmology
from ..core import containers, skysim
from ..healpix import pixel as hpx
from ..healpix import transforms as hputil
from ..ops import pmesh as pmesh_ops
from ..ops.pmesh import za_density_sph  # parity re-export (ref lss.py:1305)
from ..pipeline import (
    ConfigError,
    PipelineStopIteration,
    Property,
    RandomTask,
    Task,
    enum,
    list_type,
)
from . import corrfunc, lssmodels, lssutil
from .lsscontainers import (
    _INTERP_TYPES,
    BiasedLSS,
    CorrelationFunction,
    InitialLSS,
    MatterPowerSpectrum,
    MultiFrequencyAngularPowerSpectrum,
)

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


@lru_cache
def get_cosmo(*args, **kwargs):
    return Cosmology(*args, **kwargs)


# Power spectra shipped with the package
_POWERSPECTRA = [
    "cora-orig",
    "planck2018_z1.0_halofit-mead-feedback",
    "planck2018_z1.0_halofit-mead",
    "planck2018_z1.0_halofit-original",
    "planck2018_z1.0_halofit-takahashi",
    "planck2018_z1.0_linear",
]


def _ps_path(name):
    return Path(_DATA_DIR) / f"ps_{name}.npz"


class MeshTaskMixin:
    """Opt-in device-mesh sharding for the LSS pipeline tasks.

    The reference's LSS chain is MPI-distributed implicitly through
    mpiarray (cora/signal/lss.py:441-474, 806-811, 1202, 1287); here the
    equivalent is explicit: set ``mesh_devices`` in the task config to
    shard the hot stages over a 1-D device mesh via
    :mod:`cora_tpu.parallel.lss`.

    mesh_devices : 0 (default) single-device; −1 all local devices;
    n > 1 a mesh over the first n devices.  The size is reduced to the
    largest value dividing the task's radial row count (the sharded
    programs require even splits); 1 falls back to the unsharded path.
    """

    mesh_devices = Property(proptype=int, default=0)

    def _get_mesh(self, n_rows: int, min_per_device: int = 1):
        n = self.mesh_devices or 0
        if not n:
            return None
        from ..parallel.mesh import make_mesh

        avail = len(jax.devices())
        n = avail if n < 0 else min(int(n), avail)
        # shard_map programs with halo exchange need >= min_per_device
        # local rows (za_density_sph_sharded's single ppermute hop only
        # reaches immediate neighbours)
        n = min(n, max(1, n_rows // max(1, min_per_device)))
        while n > 1 and n_rows % n:
            n -= 1
        if n <= 1:
            return None
        return make_mesh(n)


class CalculateCorrelations(Task):
    """Density/potential correlation functions from a power spectrum.

    Produces corr0 (δδ), corr2 (δφ, P·k⁻²) and corr4 (φφ, P·k⁻⁴) with
    tanh k-cutoffs regularising both ends (reference lss.py:50-179).
    """

    minlogr = Property(proptype=float, default=-1)
    maxlogr = Property(proptype=float, default=5)
    switchlogr = Property(proptype=float, default=1)
    samples_per_decade = Property(proptype=int, default=1000)
    ksmooth = Property(proptype=float, default=None)
    logkcut_low = Property(proptype=float, default=-4)
    logkcut_high = Property(proptype=float, default=4)
    powerspectrum = enum(_POWERSPECTRA, default="planck2018_z1.0_halofit-mead")
    r_interp_type = enum(_INTERP_TYPES, default="sinh")

    def setup(self, powerspectrum: Optional[MatterPowerSpectrum] = None):
        if powerspectrum is None:
            fpath = _ps_path(self.powerspectrum)
            self.log.info(f"Loading power spectrum file {fpath}")
            powerspectrum = MatterPowerSpectrum.from_file(str(fpath))
        self._ps = powerspectrum

    def _ps_n(self, n):
        ks = 1e10 if self.ksmooth is None else self.ksmooth

        def _ps(k):
            return (
                lssutil.cutoff(k, self.logkcut_low, 1, 0.5, 6)
                * lssutil.cutoff(k, self.logkcut_high, -1, 0.5, 4)
                * np.exp(-0.5 * (k / ks) ** 2)
                * self._ps.powerspectrum(k, 0.0)
                * k**-n
            )

        return _ps

    def process(self) -> CorrelationFunction:
        """Calculate corr0/corr2/corr4 and pack them in a container."""
        self.log.debug("Generating C_dd(r)")
        k0, c0 = corrfunc.ps_to_corr(
            self._ps_n(0),
            minlogr=self.minlogr,
            maxlogr=self.maxlogr,
            switchlogr=self.switchlogr,
            samples_per_decade=self.samples_per_decade,
            pad_low=4,
            pad_high=6,
            richardson_n=9,
        )
        self.log.debug("Generating C_dp(r)")
        k2, c2 = corrfunc.ps_to_corr(
            self._ps_n(2),
            minlogr=self.minlogr,
            maxlogr=self.maxlogr,
            switchlogr=self.switchlogr,
            samples_per_decade=self.samples_per_decade,
            pad_low=4,
            pad_high=6,
            richardson_n=9,
        )
        self.log.debug("Generating C_pp(r)")
        k4, c4 = corrfunc.ps_to_corr(
            self._ps_n(4),
            minlogr=self.minlogr,
            maxlogr=self.maxlogr,
            switchlogr=self.switchlogr,
            samples_per_decade=self.samples_per_decade,
            pad_low=4,
            pad_high=6,
            richardson_n=9,
        )

        func = CorrelationFunction(attrs_from=self._ps, cosmology=self._ps.cosmology)
        func.add_function("corr0", k0, c0, type=self.r_interp_type, x_t=k0[1], f_t=1e-3)
        func.add_function("corr2", k2, c2, type=self.r_interp_type, x_t=k2[1], f_t=1e-6)
        func.add_function("corr4", k4, c4, type=self.r_interp_type, x_t=k4[1], f_t=1e2)

        self.done = True
        return func


class BlendNonLinearPowerSpectrum(Task):
    """Linear combination of a linear and a non-linear power spectrum."""

    alpha_NL = Property(proptype=float, default=1.0)
    powerspectrum_linear = enum(_POWERSPECTRA, default="planck2018_z1.0_linear")
    powerspectrum_nonlinear = enum(
        _POWERSPECTRA, default="planck2018_z1.0_halofit-mead"
    )

    def process(self) -> MatterPowerSpectrum:
        ps_linear = MatterPowerSpectrum.from_file(
            str(_ps_path(self.powerspectrum_linear))
        )
        ps_nonlinear = MatterPowerSpectrum.from_file(
            str(_ps_path(self.powerspectrum_nonlinear))
        )

        if ps_linear._ps_redshift != ps_nonlinear._ps_redshift:
            raise RuntimeError("Linear and non-linear PS redshifts do not match.")
        if not np.array_equal(
            ps_linear.index_map["x_powerspectrum"],
            ps_nonlinear.index_map["x_powerspectrum"],
        ):
            raise RuntimeError("Linear and non-linear PS k axes do not match.")

        psl = ps_linear.datasets["powerspectrum"]
        psnl = ps_nonlinear.datasets["powerspectrum"]
        ps_linear.datasets["powerspectrum"] = (
            psl * (1 - self.alpha_NL) + psnl * self.alpha_NL
        )
        ps_linear._function_cache = {}
        ps_linear.attrs["tag"] = f"psblend_alphaNL_{self.alpha_NL}"

        self.done = True
        return ps_linear


class CalculateMultiFrequencyAngularPowerSpectrum(Task):
    """C_l(chi, chi') from real-space correlation functions.

    The Gauss-Legendre quadrature runs as one jitted device program per
    correlation component (see corrfunc.corr_to_clarray).
    """

    nside = Property(proptype=int)
    redshift = Property(proptype=lssutil.linspace, default=None)
    frequencies = Property(proptype=lssutil.linspace, default=None)
    xromb = Property(proptype=int, default=2)
    leg_q = Property(proptype=int, default=4)
    leg_chunksize = Property(proptype=int, default=50)
    corrfunc_interp_type = enum(_INTERP_TYPES, default=None)

    def process(
        self, correlation_functions: CorrelationFunction
    ) -> MultiFrequencyAngularPowerSpectrum:
        if self.redshift is None and self.frequencies is None:
            raise RuntimeError("Redshifts or frequencies must be specified!")

        cosmology = correlation_functions.cosmology

        corr0 = correlation_functions.get_function(
            "corr0", interp_type=self.corrfunc_interp_type
        )
        corr2 = correlation_functions.get_function(
            "corr2", interp_type=self.corrfunc_interp_type
        )
        corr4 = correlation_functions.get_function(
            "corr4", interp_type=self.corrfunc_interp_type
        )

        if self.frequencies is None:
            redshift = self.redshift
        else:
            redshift = constants.nu21 / self.frequencies - 1.0

        xa = cosmology.comoving_distance(redshift)

        # Do not raise: higher powers alias down through the map transform.
        lmax = 3 * self.nside - 1

        self.log.debug("Generating C_l(x, x') for delta-delta")
        cla0 = corrfunc.corr_to_clarray(corr0, lmax, xa, xromb=self.xromb, q=self.leg_q)
        self.log.debug("Generating C_l(x, x') for phi-delta")
        cla2 = corrfunc.corr_to_clarray(corr2, lmax, xa, xromb=self.xromb, q=self.leg_q)
        self.log.debug("Generating C_l(x, x') for phi-phi")
        cla4 = corrfunc.corr_to_clarray(corr4, lmax, xa, xromb=self.xromb, q=self.leg_q)

        if self.frequencies is not None:
            out_cont = MultiFrequencyAngularPowerSpectrum(
                cosmology=cosmology, freq=self.frequencies, lmax=lmax
            )
        else:
            out_cont = MultiFrequencyAngularPowerSpectrum(
                cosmology=cosmology, redshift=redshift, lmax=lmax
            )

        out_cont.Cl_delta_delta[:] = cla0
        out_cont.Cl_phi_delta[:] = cla2
        out_cont.Cl_phi_phi[:] = cla4
        self.done = True
        return out_cont


class GenerateInitialLSSFromCl(MeshTaskMixin, Task):
    """Realise initial (phi, delta) fields from an angular power spectrum.

    Builds the 2Nz×2Nz joint covariance per ell and draws correlated maps
    with the device synthesis engine (reference lss.py:376-478).  With
    ``mesh_devices`` set the draw runs ℓ-sharded and the SHT chi-sharded
    (the reference's MPI layout, lss.py:441-474) via
    :func:`cora_tpu.parallel.lss.initial_lss_sharded`.
    """

    nside = Property(proptype=int, default=None)
    num_sims = Property(proptype=int, default=1)
    start_seed = Property(proptype=int, default=0)

    def setup(self, aps: MultiFrequencyAngularPowerSpectrum):
        self.aps = aps
        self.cosmology = aps.cosmology
        self.seed = self.start_seed

        nside_from_cl = hputil.nside_for_lmax(
            len(aps.ell) - 1, accuracy_boost=0
        )
        if self.nside is None:
            self.nside = nside_from_cl
            self.log.info(f"Set nside={self.nside} from input C_l container")
        elif self.nside > nside_from_cl:
            raise RuntimeError(
                f"Requested nside ({self.nside}) cannot exceed nside for the "
                f"input C_l ({nside_from_cl})"
            )

    def process(self) -> InitialLSS:
        if self.num_sims == 0:
            raise PipelineStopIteration()
        self.num_sims -= 1

        nz = len(self.aps.chi)
        nell = len(self.aps.ell)

        # joint (phi, delta) covariance per ell
        cla = np.zeros((nell, 2 * nz, 2 * nz))
        cla[:, nz:, nz:] = self.aps.Cl_delta_delta
        cla[:, :nz, nz:] = self.aps.Cl_phi_delta
        cla[:, nz:, :nz] = self.aps.Cl_phi_delta
        cla[:, :nz, :nz] = self.aps.Cl_phi_phi

        self.log.info(f"Generating realisation of fields using seed {self.seed}")
        mesh = self._get_mesh(2 * nz)
        if mesh is not None:
            from ..parallel.lss import initial_lss_sharded

            self.log.info(f"Drawing on a {mesh.shape} device mesh")
            sky = initial_lss_sharded(
                cla, self.nside, jax.random.PRNGKey(self.seed), mesh
            )
        else:
            sky = skysim.mkfullsky(
                cla, self.nside, key=jax.random.PRNGKey(self.seed)
            )

        kwargs = {}
        if "freq" in self.aps.index_map:
            kwargs["freq"] = self.aps.freq
        else:
            kwargs["redshift"] = self.aps.redshift
        f = InitialLSS(cosmology=self.cosmology, nside=self.nside, **kwargs)

        f.phi[:] = sky[:nz]
        f.delta[:] = sky[nz:]

        self.seed += 1
        return f


class GenerateInitialLSS(
    CalculateMultiFrequencyAngularPowerSpectrum, GenerateInitialLSSFromCl
):
    """Generate initial LSS maps directly from a correlation function."""

    def setup(self, correlation_functions: CorrelationFunction):
        self.done = False
        aps = CalculateMultiFrequencyAngularPowerSpectrum.process(
            self, correlation_functions
        )
        self.done = False
        GenerateInitialLSSFromCl.setup(self, aps)

    def process(self):
        return GenerateInitialLSSFromCl.process(self)


class GenerateBiasedFieldBase(Task):
    r"""Generate a (Lagrangian-space) biased field from the initial field.

    .. math::
        \delta_B = D(z) b_1(z) \delta_L
        + D(z)^2 b_2(z) (\delta_L^2 - \langle\delta_L^2\rangle)
    """

    lightcone = Property(proptype=bool, default=True)
    redshift = Property(proptype=float, default=None)
    lognormal = Property(proptype=bool, default=False)

    def _bias_1(self, z):
        raise NotImplementedError("Must be overridden in subclass.")

    def _bias_2(self, z):
        raise NotImplementedError("Must be overridden in subclass.")

    def process(self, f: InitialLSS) -> BiasedLSS:
        """Create the biased field."""
        biased_field = BiasedLSS(
            lightcone=self.lightcone,
            fixed_redshift=self.redshift,
            axes_from=f,
            attrs_from=f,
        )
        biased_field.delta[:] = 0.0

        z = f.redshift if self.lightcone else self.redshift * np.ones_like(f.chi)
        D = f.cosmology.growth_factor(z) / f.cosmology.growth_factor(0)

        fd = f.delta

        try:
            b1 = self._bias_1(z)
            biased_field.delta[:] += (D * b1)[:, np.newaxis] * fd
        except NotImplementedError:
            self.log.info("First order bias is not implemented. This is a bit odd.")

        try:
            b2 = self._bias_2(z)
            d2m = (fd**2).mean(axis=1)[:, np.newaxis]
            biased_field.delta[:] += (D**2 * b2)[:, np.newaxis] * (fd**2 - d2m)
        except NotImplementedError:
            self.log.debug("No second order bias to apply.")

        if self.lognormal:
            lssutil.lognormal_transform(
                biased_field.delta,
                out=biased_field.delta,
                axis=(1 if self.lightcone else None),
            )

        return biased_field

    def _crop_low(self, x, cut=0.0):
        mask = x < cut
        x[mask] = cut
        self.log.debug(f"Fraction of pixels cropped {mask.mean()}.")


class GenerateConstantBias(GenerateBiasedFieldBase):
    """Constant linear Lagrangian bias (b_L = b_E − 1)."""

    bias_L = Property(proptype=float, default=0.0)

    def _bias_1(self, z):
        return np.ones_like(z) * self.bias_L


class GeneratePolynomialBias(GenerateBiasedFieldBase):
    r"""Polynomial Lagrangian bias b_1(z) = Σ c_n (z − z_eff)^n."""

    z_eff = Property(proptype=float, default=None)
    bias_coeff = list_type(type_=float, default=None)
    model = enum(lssmodels.bias.models(), default=None)
    alpha_b = Property(proptype=float, default=1.0)

    def setup(self):
        if self.z_eff is not None and self.bias_coeff is not None:

            def b(z):
                return lssmodels.PolyModelSet.evaluate_poly(
                    z, self.z_eff, self.bias_coeff
                )

            self._bias = b
        elif self.model is not None:
            self._bias = lssmodels.bias[self.model]
        else:
            raise ConfigError("Either `model` must be set, or `z_eff` and `bias_coeff`")

    def _bias_1(self, z):
        bias = self._bias(z)
        # Eulerian-bias scaling: no-op at alpha_b = 1
        return self.alpha_b * bias + self.alpha_b - 1.0


class DynamicsBase(MeshTaskMixin, Task):
    """Base for the dynamics tasks mapping biased fields to final fields."""

    redshift_space = Property(proptype=bool, default=True)

    def _validate_fields(self, initial_field: InitialLSS, biased_field: BiasedLSS):
        if (initial_field.chi != biased_field.chi).any():
            raise ValueError("Radial axes do not match between fields.")
        if (
            biased_field.index_map["pixel"] != initial_field.index_map["pixel"]
        ).any():
            raise ValueError("Angular axes do not match between fields.")

    def _get_props(self, biased_field: BiasedLSS):
        c = biased_field.cosmology
        nside = hpx.npix2nside(biased_field.delta.shape[1])
        chi = biased_field.chi

        if biased_field.lightcone:
            if "redshift" not in biased_field.index_map:
                raise ValueError("Biased field does not have a redshift label.")
            za = biased_field.redshift
        else:
            za = np.ones_like(chi) * biased_field.fixed_redshift

        return c, nside, biased_field.lightcone, chi, za


class ZeldovichDynamics(DynamicsBase):
    """Zel'dovich dynamics: displace particles by the potential gradient.

    ψ = ∇φ via batched spin-1 synthesis (angular) + radial finite
    differences, growth scaling, optional (1+f) RSD boost, then an SPH
    scatter-add onto the final grid — the reference's per-slice
    healpy+Cython hot loop (lss.py:763-858, 1305-1419) as device programs.
    """

    sph = Property(proptype=bool, default=True)
    mesh_halo = Property(proptype=int, default=4)
    # SPH mass-deposit algorithm: "auto" (scatter single-device, stencil
    # on a mesh), "scatter", or "stencil" — belt roll-adds (poisons on
    # >window displacements rather than dropping mass)
    deposit = Property(proptype=str, default="auto")
    # neighbour centre vectors: "table" (precomputed, gathered) or
    # "arith" (computed from pixel ids on the fly — drops the largest
    # geometry table, f32 weight change ~4e-7; memory headroom for
    # nside>=512 deposits)
    vectors = Property(proptype=str, default="table")

    def process(self, initial_field: InitialLSS, biased_field: BiasedLSS) -> BiasedLSS:
        self._validate_fields(initial_field, biased_field)
        c, nside, _, chi, za = self._get_props(biased_field)

        D = c.growth_factor(za) / c.growth_factor(0)

        mesh = self._get_mesh(len(chi), min_per_device=self.mesh_halo)
        if self.sph and mesh is not None:
            from ..parallel.lss import zeldovich_sharded

            self.log.info(f"Zel'dovich step on a {mesh.shape} device mesh")
            final_field = BiasedLSS(axes_from=biased_field, attrs_from=biased_field)
            # geometry tables built on host once and shipped through the
            # deposit's jit arguments (closure constants exceed remote
            # compile payload limits at nside>=512)
            geometry = pmesh_ops.sph_geometry(
                nside, device=False, vectors=self.vectors != "arith"
            )
            out = zeldovich_sharded(
                initial_field.phi,
                initial_field.delta,
                biased_field.delta,
                chi,
                D,
                c.growth_rate(za),
                nside,
                mesh,
                redshift_space=self.redshift_space,
                halo=self.mesh_halo,
                deposit="stencil" if self.deposit == "auto" else self.deposit,
                vectors=self.vectors,
                geometry=geometry,
            )
            final_field.delta[:] = np.asarray(out)
            return final_field

        # displacement field psi = grad phi
        vpsi = lssutil.gradient(initial_field.phi, chi, grad0=True)
        vpsi *= D[np.newaxis, :, np.newaxis]

        theta, _ = hputil.ang_positions(nside).T

        vpsi[1:3] /= chi[np.newaxis, :, np.newaxis]
        vpsi[2] /= np.sin(theta[np.newaxis, :])

        if self.redshift_space:
            fr = c.growth_rate(za)
            vpsi[0] *= (1 + fr)[:, np.newaxis]

        final_field = BiasedLSS(axes_from=biased_field, attrs_from=biased_field)

        delta_m = initial_field.delta * D[:, np.newaxis]
        delta_bias = biased_field.delta

        if self.sph:
            sigma_chi = np.mean(abs(np.diff(chi))) / 2
            out = pmesh_ops.za_density_sph(
                jnp.asarray(vpsi),
                jnp.asarray(delta_bias),
                jnp.asarray(delta_m),
                jnp.asarray(chi),
                nside,
                sigma_chi=sigma_chi,
                deposit=self.deposit,
                vectors=self.vectors,
            )
            final_field.delta[:] = np.asarray(out)
        else:
            za_density_grid(
                vpsi, delta_bias, delta_m, chi, final_field.delta
            )

        return final_field


class LinearDynamics(DynamicsBase):
    """First-order Eulerian dynamics (+ linear RSD via −D f ∂²φ/∂χ²)."""

    def process(self, initial_field: InitialLSS, biased_field: BiasedLSS) -> BiasedLSS:
        self._validate_fields(initial_field, biased_field)
        c, _, __, chi, za = self._get_props(biased_field)

        final_field = BiasedLSS(axes_from=biased_field, attrs_from=biased_field)

        D = c.growth_factor(za) / c.growth_factor(0)

        mesh = self._get_mesh(len(chi))
        if mesh is not None:
            from ..parallel.lss import linear_dynamics_sharded

            self.log.info(f"Linear dynamics on a {mesh.shape} device mesh")
            frD = D * c.growth_rate(za) if self.redshift_space else None
            out = linear_dynamics_sharded(
                initial_field.phi,
                initial_field.delta,
                biased_field.delta,
                chi,
                D,
                frD,
                mesh,
            )
            final_field.delta[:] = np.asarray(out)
            return final_field

        final_field.delta[:] = biased_field.delta
        # Lagrangian bias = Eulerian − 1: add the growth-scaled initial delta
        final_field.delta[:] += D[:, np.newaxis] * initial_field.delta

        if self.redshift_space:
            fr = c.growth_rate(za)
            vterm = lssutil.diff2(initial_field.phi, chi, axis=0)
            vterm *= -(D * fr)[:, np.newaxis]
            final_field.delta[:] += vterm

        return final_field


class BiasedLSSToMap(Task):
    """Convert a BiasedLSS field into a (Stokes-I) Map container."""

    use_mean_21cmT = Property(proptype=int, default=False)
    map_prefactor = Property(proptype=float, default=1.0)
    lognormal = Property(proptype=bool, default=False)
    omega_HI_model = enum(lssmodels.omega_HI.models(), default="Crighton2015")

    def process(self, biased_lss: BiasedLSS) -> containers.Map:
        n_freq = len(biased_lss.freq)
        freqmap = np.zeros(
            n_freq, dtype=[("centre", np.float64), ("width", np.float64)]
        )
        freqmap["centre"][:] = biased_lss.freq
        freqmap["width"][:] = np.abs(np.diff(biased_lss.freq)[0])

        m = containers.Map(
            freq=freqmap,
            polarisation=True,
            axes_from=biased_lss,
            attrs_from=biased_lss,
        )

        if self.lognormal:
            lssutil.lognormal_transform(
                biased_lss.delta, out=m.map[:, 0], axis=1
            )
        else:
            m.map[:, 0, :] = biased_lss.delta

        if self.map_prefactor != 1:
            self.log.info(f"Multiplying map by {self.map_prefactor}")
            m.map[:] *= self.map_prefactor

        if self.use_mean_21cmT:
            if biased_lss.lightcone:
                z = biased_lss.redshift
            else:
                z = biased_lss.fixed_redshift * np.ones_like(biased_lss.redshift)

            omHI = lssmodels.omega_HI.evaluate(z, model=self.omega_HI_model)
            T_b = lssmodels.mean_21cm_temperature(biased_lss.cosmology, z, omHI)
            m.map[:, 0] *= T_b[:, np.newaxis]

        return m


class FingersOfGod(MeshTaskMixin, Task):
    r"""Radial exponential smoothing approximating Fingers of God.

    Equivalent to a squared-Lorentzian suppression in k-space; one matmul
    over the radial axis (reference lss.py:1099-1220).
    """

    model = enum(lssmodels.sigma_P.models(), default=None)
    alpha_FoG = Property(proptype=float, default=1.0)
    FoG_coeff = list_type(type_=float, default=None)
    z_eff = Property(proptype=float, default=None)
    apply_growth_factor = Property(proptype=bool, default=True)

    def setup(self, cosmo_cont=None):
        if self.z_eff is not None and self.FoG_coeff is not None:

            def s(z):
                return lssmodels.PolyModelSet.evaluate_poly(
                    z, self.z_eff, self.FoG_coeff
                )

            self._sigma_P = s
        elif self.model is not None:
            self._sigma_P = lssmodels.sigma_P[self.model]
        else:
            raise ConfigError("Either `model` must be set, or `z_eff` and `FoG_coeff`")

        if cosmo_cont is not None:
            self.cosmo = cosmo_cont.cosmology
        else:
            self.cosmo = get_cosmo()

    def process(self, field):
        """Apply the FoG smoothing to a BiasedLSS or Map."""
        if self.alpha_FoG == 0.0:
            return field

        if isinstance(field, BiasedLSS):
            if field.lightcone:
                redshift = field.redshift
            else:
                redshift = field.fixed_redshift * np.ones_like(field.redshift)
            chi = field.chi
        else:
            redshift = constants.nu21 / field.freq - 1.0
            chi = self.cosmo.comoving_distance(redshift)

        if self.apply_growth_factor:
            D = field.cosmology.growth_factor(redshift)
        else:
            D = np.full(redshift.shape, 1.0)
        sigmaP = self._sigma_P(redshift)

        K = lssutil.exponential_FoG_kernel(chi, self.alpha_FoG * sigmaP, D)
        K_d = jnp.asarray(K)

        smoothed_field = field.__class__(axes_from=field, attrs_from=field)

        mesh = self._get_mesh(len(chi))
        if mesh is not None:
            from ..parallel.lss import fog_sharded

            self.log.info(f"FoG matmul on a {mesh.shape} device mesh")
            if isinstance(field, BiasedLSS):
                smoothed_field.delta[:] = np.asarray(
                    fog_sharded(K, field.delta, mesh)
                )
            else:
                n_freq = len(field.freq)
                flat = field.map.reshape(n_freq, -1)
                smoothed_field.map[:] = np.asarray(
                    fog_sharded(K, flat, mesh)
                ).reshape(field.map.shape)
            return smoothed_field

        hi = jax.lax.Precision.HIGHEST
        if isinstance(field, BiasedLSS):
            smoothed_field.delta[:] = np.asarray(
                jnp.matmul(K_d, jnp.asarray(field.delta), precision=hi))
        else:
            n_freq = len(field.freq)
            flat = jnp.asarray(field.map.reshape(n_freq, -1))
            smoothed_field.map[:] = np.asarray(
                jnp.matmul(K_d, flat, precision=hi)
            ).reshape(field.map.shape)

        return smoothed_field


class AddCorrelatedShotNoise(MeshTaskMixin, RandomTask):
    """Add a correlated shot-noise realisation to each input field.

    The seed is derived deterministically from the content of the common
    InitialLSS field (adler32 hash; reference lss.py:1256-1263) so that all
    tasks sharing it generate identical shot noise.

    With ``mesh_devices`` set, the fill is chi-sharded through the keyed
    device RNG (:func:`cora_tpu.parallel.lss.shot_noise_sharded`): the
    realisation is identical on ANY mesh size (jax.random bits are a pure
    function of key and position) but differs from the host numpy stream
    of the unsharded path.
    """

    n_eff = Property(proptype=float, default=None)
    log_M_HI_g = Property(proptype=float, default=None)
    omega_HI_model = enum(lssmodels.omega_HI.models(), default="Crighton2015")

    def setup(self, lss: InitialLSS):
        import zlib

        lss_subset = np.ascontiguousarray(lss.delta[:, :100]).tobytes()
        if self.seed is None:
            self.seed = zlib.adler32(lss_subset)

        if self.n_eff is not None:
            self._n_eff_z = np.ones_like(lss.chi) * self.n_eff
        elif self.log_M_HI_g is not None:
            self._n_eff_z = lssmodels.log_M_HI_g_to_n_eff(
                self.log_M_HI_g, lss.cosmology, lss.redshift, self.omega_HI_model
            )
        else:
            raise RuntimeError("One of `n_eff` or `log_M_HI_g` must be set.")

    def process(self, input_field: BiasedLSS) -> BiasedLSS:
        """Add shot noise in place and return the field."""
        pixarea = hpx.nside2pixarea(input_field.nside)
        ichi = input_field.chi

        volume = pixarea * (ichi**2) * lssutil.calculate_width(ichi)
        std = (volume * self._n_eff_z) ** -0.5

        mesh = self._get_mesh(len(ichi))
        if mesh is not None:
            from ..parallel.lss import shot_noise_sharded

            self.log.info(f"Shot-noise fill on a {mesh.shape} device mesh")
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
            shot_noise = np.asarray(
                shot_noise_sharded(
                    jax.random.PRNGKey(self.seed),
                    std,
                    input_field.delta.shape,
                    mesh,
                    dtype=dtype,
                )
            )
        else:
            shot_noise = self.rng.normal(
                scale=std[:, np.newaxis], size=input_field.delta.shape
            )
        input_field.delta[:] += shot_noise
        return input_field


class GenerateFlatSpectrumMap(MeshTaskMixin, RandomTask):
    """Full-frequency flat-spectrum noise-like map with specified power."""

    nside = Property(proptype=int, default=512)
    frequencies = Property(proptype=lssutil.linspace, default=None)
    full_pol = Property(proptype=bool, default=True)
    pol = Property(proptype=list, default=["I"])
    variance = Property(proptype=float, default=None)
    P_SN = Property(proptype=float, default=None)
    use_freq_dependent_voxel_volume = Property(proptype=bool, default=False)
    num_sims = Property(proptype=int, default=1)

    def setup(self):
        if (self.variance is None) == (self.P_SN is None):
            raise ValueError("Exactly one of variance or P_SN must be specified.")
        if not self.full_pol and self.pol != ["I"]:
            raise RuntimeError("Must have full_pol=True for nonzero non-I maps.")

    def process(self) -> containers.Map:
        freq = self.frequencies
        nfreq = len(freq)
        redshift = constants.nu21 / freq - 1
        freqmap = np.zeros(
            nfreq, dtype=[("centre", np.float64), ("width", np.float64)]
        )
        freqmap["centre"][:] = freq
        freqmap["width"][:] = np.abs(np.diff(freq)[0])

        ref_chan = int(nfreq / 2.0)

        omega = hpx.nside2pixarea(self.nside)
        if self.use_freq_dependent_voxel_volume:
            dV = differential_comoving_volume(redshift)
            dz = lssutil.calculate_width(redshift)
        else:
            dV = differential_comoving_volume(redshift[ref_chan])
            dz = abs(redshift[ref_chan + 1] - redshift[ref_chan])
        voxvol = dV * dz * omega

        m = containers.Map(
            freq=freqmap, polarisation=self.full_pol, nside=self.nside
        )

        if self.variance is not None:
            scale = self.variance**0.5
        else:
            scale = self.P_SN**0.5
            if self.use_freq_dependent_voxel_volume:
                scale = scale / voxvol[:, np.newaxis, np.newaxis] ** 0.5
            else:
                scale = scale / voxvol**0.5

        pol_axis = list(m.index_map["pol"])
        ipol = [pol_axis.index(p) for p in self.pol]

        mesh = self._get_mesh(nfreq)
        if mesh is not None:
            # chi-sharded keyed fill (the reference fills its freq shards
            # locally, lss.py:1521); mesh-size invariant like shot noise
            from ..parallel.lss import shot_noise_sharded

            self.log.info(f"Flat-spectrum fill on a {mesh.shape} mesh")
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
            std = np.broadcast_to(
                np.asarray(scale, dtype=np.float64).reshape(-1), (nfreq,)
            )
            for k in ipol:
                noise = shot_noise_sharded(
                    jax.random.fold_in(
                        jax.random.PRNGKey(self.seed or 0), k
                    ),
                    std, (nfreq, m.map.shape[-1]), mesh, dtype=dtype,
                )
                m.map[:, k, :] = np.asarray(noise)
        else:
            m.map[:, ipol, :] = self.rng.normal(
                scale=scale, size=(nfreq, len(ipol), m.map.shape[-1])
            )

        m.attrs["voxvol_ref"] = voxvol
        m.attrs["central_redshift"] = redshift[ref_chan]

        if self._count + 1 >= self.num_sims:
            self.done = True

        return m


def za_density_grid(psi, delta_bias, delta_m, chi, out):
    """Zel'dovich density via grid (cloud-in-cell-like) assignment.

    Host/numpy implementation matching the reference (lss.py:996-1097):
    bilinear pixel interpolation weights + two-bin radial weights.
    """
    nchi, npix = delta_bias.shape

    lssutil.assert_shape(psi, (3, nchi, npix), "psi")
    lssutil.assert_shape(delta_m, (nchi, npix), "delta_m")
    lssutil.assert_shape(chi, (nchi,), "chi")
    lssutil.assert_shape(out, (nchi, npix), "out")

    # the radial binning below assumes ascending chi; flip if needed
    if nchi > 1 and chi[1] < chi[0]:
        za_density_grid(
            psi[:, ::-1], delta_bias[::-1], delta_m[::-1], chi[::-1], out[::-1]
        )
        return out

    nside = hpx.npix2nside(npix)
    angpos = np.array(hpx.pix2ang(nside, np.arange(npix)))

    chi_ext = np.zeros(len(chi) + 2, dtype=chi.dtype)
    chi_ext[1:-1] = chi
    chi_ext[0] = chi[0] - (chi[1] - chi[0])
    chi_ext[-1] = chi[-1] + (chi[-1] - chi[-2])

    from ..util.pmesh import _bin_delta, calculate_positions

    out[:] = 0.0

    for ii in range(nchi):
        density_slice = 1 + delta_bias[ii]
        psi_slc = psi[:, ii]

        new_angpos = calculate_positions(angpos, psi_slc[1:])
        new_chi = chi[ii] + psi_slc[0]

        pixel_ind, pixel_weight = hpx.get_interp_weights(
            nside, new_angpos[0], new_angpos[1]
        )

        chi_ext_ind = np.digitize(new_chi, chi_ext)
        chi0 = chi_ext[(chi_ext_ind - 1) % (nchi + 2)]
        chi1 = chi_ext[chi_ext_ind % (nchi + 2)]
        dchi = chi1 - chi0

        w0 = np.abs((chi1 - new_chi) / dchi)
        w1 = np.abs((new_chi - chi0) / dchi)
        i0 = chi_ext_ind - 2
        i1 = chi_ext_ind - 1

        w0[(i0 < 0) | (i0 >= nchi)] = 0.0
        w1[(i1 < 0) | (i1 >= nchi)] = 0.0
        i0 = np.clip(i0, 0, nchi - 1)
        i1 = np.clip(i1, 0, nchi - 1)

        radial_ind = np.array([i0, i1])
        radial_weight = np.array([w0, w1])

        _bin_delta(
            density_slice,
            pixel_ind.T.astype(np.int32, order="C"),
            pixel_weight.T.copy(),
            radial_ind.T.astype(np.int32, order="C"),
            radial_weight.T.copy(),
            out,
        )

    out[:] -= 1.0
    return out


def differential_comoving_volume(z, cosmo=None):
    """Differential comoving volume dV/dz/dΩ at z, in (Mpc/h)³/sr."""
    if cosmo is None:
        cosmo = get_cosmo()

    H_z = cosmo.H(z) * (cosmo._unit_distance / 1000.0)
    dm = cosmo.comoving_distance(z)
    return dm**2 * (constants.c / 1e3) / H_z
