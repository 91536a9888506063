"""Map geometry classes.

API-compatible re-design of the reference ``cora/core/maps.py``: the
``Map2d``/``Map3d``/``Sky3d`` classes carry angular-patch and frequency-band
geometry and the ``getsky``/``getpolsky``/``getalms`` template methods.

The synthesis itself (``Sky3d.getsky``) is delegated to the device
engine in :mod:`cora_tpu.core.skysim`; models opt into the fast on-device
channel-window integration via ``channel_integration`` (default keeps the
reference's Romberg-oversampling semantics).
"""

from __future__ import annotations

import numpy as np

from .. import constants


class Map2d:
    """A 2-d sky patch geometry.

    Attributes
    ----------
    x_width, y_width : float
        Angular size along each axis (degrees).
    x_num, y_num : int
        Pixels along each angular axis.
    """

    x_width = 5.0
    y_width = 5.0

    x_num = 128
    y_num = 128

    _nside = 128

    @classmethod
    def like_map(cls, mapobj, *args, **kwargs):
        """Create an object of this class with the same geometry as `mapobj`."""
        c = cls(*args, **kwargs)
        c.x_width = mapobj.x_width
        c.y_width = mapobj.y_width
        c.x_num = mapobj.x_num
        c.y_num = mapobj.y_num
        c._nside = mapobj._nside
        return c

    def _width_array(self):
        return (
            np.array([self.x_width, self.y_width], dtype=np.float64) * constants.degree
        )

    def _num_array(self):
        return np.array([self.x_num, self.y_num], dtype=int)

    @property
    def x_pixels(self):
        return (np.arange(self.x_num) + 0.5) * (self.x_width / self.x_num)

    @property
    def y_pixels(self):
        return (np.arange(self.y_num) + 0.5) * (self.y_width / self.y_num)

    @property
    def nside(self):
        """HEALPix resolution (must be a power of two)."""
        return self._nside

    @nside.setter
    def nside(self, value):
        ns = int(value)
        lns = np.log2(ns)
        if int(lns) != lns or lns < 0:
            raise Exception("Not a valid value of nside.")
        self._nside = ns


class Map3d(Map2d):
    """A 3-d sky map geometry: angular patch plus a frequency axis.

    Frequency band semantics mirror the reference (maps.py:93-106): the
    default mode puts `nu_num` channel centres between the band edges
    `nu_lower`/`nu_upper`; an explicit `frequencies` array overrides.
    """

    nu_lower = 500.0
    nu_upper = 900.0

    @classmethod
    def like_map(cls, mapobj, *args, **kwargs):
        c = cls(*args, **kwargs)
        c.x_width = mapobj.x_width
        c.y_width = mapobj.y_width
        c.x_num = mapobj.x_num
        c.y_num = mapobj.y_num
        c._nside = mapobj._nside
        c.nu_upper = mapobj.nu_upper
        c.nu_lower = mapobj.nu_lower
        c.nu_num = mapobj.nu_num
        c._frequencies = mapobj._frequencies
        return c

    def _width_array(self):
        return np.array(
            [
                self.nu_upper - self.nu_lower,
                self.x_width * constants.degree,
                self.y_width * constants.degree,
            ],
            dtype=np.float64,
        )

    def _num_array(self):
        return np.array([self.nu_num, self.x_num, self.y_num], dtype=int)

    _frequencies = None
    _nu_num = 128

    @property
    def nu_num(self):
        return len(self.frequencies)

    @nu_num.setter
    def nu_num(self, num):
        self._nu_num = num

    @property
    def frequencies(self):
        """Channel centre frequencies in MHz."""
        if self._frequencies is not None:
            return self._frequencies
        return self.nu_lower + (np.arange(self._nu_num) + 0.5) * (
            (self.nu_upper - self.nu_lower) / self._nu_num
        )

    @frequencies.setter
    def frequencies(self, freq):
        self._frequencies = np.asarray(freq, dtype=np.float64)

    # Alias matching the reference attribute name.
    nu_pixels = frequencies

    @classmethod
    def like_kiyo_map(cls, mapobj, *args, **kwargs):
        """Create a Map3d matching a kiyo-style map object's geometry.

        Expects `mapobj.get_axis(name)` for freq/ra/dec axes and an `info`
        dict with `dec_centre` (reference maps.py:175-200).
        """
        c = cls(*args, **kwargs)

        freq_axis = mapobj.get_axis("freq")
        ra_axis = mapobj.get_axis("ra")
        dec_axis = mapobj.get_axis("dec")

        ra_fact = np.cos(np.pi * mapobj.info["dec_centre"] / 180.0)
        c.x_width = (max(ra_axis) - min(ra_axis)) * ra_fact
        c.y_width = max(dec_axis) - min(dec_axis)
        c.x_num, c.y_num = (len(ra_axis), len(dec_axis))

        c.nu_lower = min(freq_axis) / 1.0e6
        c.nu_upper = max(freq_axis) / 1.0e6
        c.nu_num = len(freq_axis)
        return c


class Sky3d(Map3d):
    """Base class for full-sky multi-frequency Gaussian map synthesis.

    Attributes
    ----------
    oversample : int
        Romberg oversampling order for finite channel-width integration
        (2**oversample + 1 sub-samples per channel; reference maps.py:214).
    seed : int or None
        RNG seed for the realisation (keyed jax.random; reproducible).
    """

    oversample = 3
    seed = None

    def angular_powerspectrum(self, l, nu1, nu2):
        """C_l(nu1, nu2) for the given map."""
        raise NotImplementedError("Not implemented in base class.")

    def mean_nu(self, freq):
        return np.zeros_like(np.asarray(freq, dtype=np.float64))

    def getfield(self):
        raise NotImplementedError("Not implemented in base class.")

    def _clarray(self, lmax=None):
        from . import skysim

        if lmax is None:
            lmax = 3 * self.nside - 1
        return skysim.clarray(
            self.angular_powerspectrum, lmax, self.nu_pixels, zromb=self.oversample
        )

    def getsky(self, key=None):
        """Create a map of the unpolarised sky (numz, npix)."""
        from . import skysim

        cla = self._clarray()
        sky = skysim.mkfullsky(cla, self.nside, key=self._key(key))
        return self.mean_nu(self.nu_pixels)[:, np.newaxis] + np.asarray(sky)

    def getpolsky(self, key=None):
        """Create a map of the fully polarised sky (Stokes I, Q, U, V)."""
        sky_I = self.getsky(key=key)
        sky_IQU = np.zeros((sky_I.shape[0], 4, sky_I.shape[1]), dtype=sky_I.dtype)
        sky_IQU[:, 0] = sky_I
        return sky_IQU

    def getalms(self, lmax, key=None):
        """Return correlated a_lm for the model (numz, lmax+1, lmax+1)."""
        from . import skysim

        cla = skysim.clarray(self.angular_powerspectrum, lmax, self.nu_pixels)
        return skysim.mkfullsky(cla, self.nside, alms=True, key=self._key(key))

    def _key(self, key=None):
        import jax

        if key is not None:
            return key
        if self.seed is not None:
            return jax.random.PRNGKey(self.seed)
        return jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
