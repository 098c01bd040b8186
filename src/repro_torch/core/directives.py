"""Legacy directive frontend — superseded by the ``repro_torch.at`` session API.

.. deprecated::
    The per-(type, feature) decorators (``install_unroll`` ...) and the
    ``SelectRegion`` class are deprecation shims kept so existing code
    and tests run unchanged.  New code declares regions through one
    surface: ``repro_torch.at.AutoTuner.autotune`` (see ``docs/API.md`` for the
    migration table).  The low-level :func:`region` decorator remains the
    shared implementation both frontends dispatch through, so shimmed and
    new declarations land in the same registry and are tuned identically.

Example (paper Sample Program 1, current surface)::

    import repro_torch.at as at
    tuner = at.AutoTuner(workdir)
    @tuner.autotune("install", "unroll", name="MyMatMul",
                    varied=at.Varied(("i", "j"), 1, 16),
                    fitting=at.Fitting.least_squares(5,
                        sampled=[1, 2, 3, 4, 5, 8, 16]))
    def my_matmul(i=1, j=1):
        return lambda: run_matmul(unroll_i=i, unroll_j=j)
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Sequence

from .cost import According
from .params import ParamDecl, Varied
from .region import ATRegion, Fitting, Subregion
from .runtime import ATContext, default_context


def _warn_deprecated(old: str, new: str, stacklevel: int = 3) -> None:
    warnings.warn(
        f"repro_torch.core.directives.{old} is deprecated; use {new} "
        f"(repro_torch.at session API)", DeprecationWarning, stacklevel=stacklevel)


def _coerce_params(params) -> list[ParamDecl]:
    out = []
    for p in params or ():
        if isinstance(p, ParamDecl):
            out.append(p)
        elif isinstance(p, (tuple, list)):
            name, attr = p
            out.append(ParamDecl(name, attr))
        else:  # "bp n" / "in CacheSize" / bare name
            parts = str(p).split()
            if len(parts) == 2:
                out.append(ParamDecl(parts[1], parts[0]))
            else:
                out.append(ParamDecl(parts[0]))
    return out


def region(ctx: ATContext | None, at_type: str, feature: str, name: str, *,
           varied: Varied | None = None, fitting: Fitting | None = None,
           params: Sequence = (), according: According | str | None = None,
           search: str | None = None, number: int | None = None,
           prepro: Callable | None = None, postpro: Callable | None = None,
           debug: tuple = (), parent: ATRegion | None = None,
           metadata: dict | None = None) -> Callable:
    """Decorator declaring a tuning region around a variant generator."""
    ctx = ctx or default_context()
    if isinstance(according, str):
        according = According.parse(according)

    def deco(fn: Callable) -> ATRegion:
        r = ATRegion(at_type=at_type, feature=feature, name=name, fn=fn,
                     params=_coerce_params(params), varied=varied,
                     fitting=fitting, according=according, search=search,
                     number=number, prepro=prepro, postpro=postpro,
                     debug=tuple(debug), metadata=metadata or {})
        if parent is not None:
            parent.add_child(r)
            ctx.registry.register(r)
        else:
            ctx.register(r)
        return r

    return deco


# deprecation shims, one per (type, feature) pair used in the paper; each
# dispatches through region() into the same registry the session API uses
def _shim(at_type: str, feature: str, ctx, kw) -> Callable:
    # stacklevel 4: user -> wrapper (install_unroll) -> _shim -> warn
    _warn_deprecated(f"{at_type}_{feature}",
                     f"AutoTuner.autotune({at_type!r}, {feature!r}, ...)",
                     stacklevel=4)
    return region(ctx, at_type, feature, kw.pop("name"), **kw)


def install_unroll(ctx=None, **kw):  # Sample 1
    return _shim("install", "unroll", ctx, kw)


def install_define(ctx=None, **kw):  # Sample 2
    return _shim("install", "define", ctx, kw)


def install_variable(ctx=None, **kw):
    return _shim("install", "variable", ctx, kw)


def static_unroll(ctx=None, **kw):   # Sample 4
    return _shim("static", "unroll", ctx, kw)


def static_variable(ctx=None, **kw):
    return _shim("static", "variable", ctx, kw)


def dynamic_variable(ctx=None, **kw):
    return _shim("dynamic", "variable", ctx, kw)


def dynamic_unroll(ctx=None, **kw):  # Sample 7
    return _shim("dynamic", "unroll", ctx, kw)


class SelectRegion:
    """Deprecated constructor of ``select`` regions (Samples 5 and 6) — use
    ``AutoTuner.autotune(phase, "select", name=...)`` instead, which needs
    no ``finalize`` step.  Original usage::

        sel = SelectRegion(ctx, "dynamic", name="PrecondSelect",
                           params=["in eps", "in iter"],
                           according="min (eps) .and. condition (iter < 5)")

        @sel.alternative()
        def process_1(...): ...

        @sel.alternative(according="estimated 4.0d0*CacheSize*...")
        def process_2(...): ...

        sel.finalize()
    """

    def __init__(self, ctx: ATContext | None, at_type: str, name: str, *,
                 params: Sequence = (), according: According | str | None = None,
                 search: str | None = None, number: int | None = None,
                 parent: ATRegion | None = None, metadata: dict | None = None):
        _warn_deprecated("SelectRegion",
                         "AutoTuner.autotune(phase, 'select', name=...)")
        self.ctx = ctx or default_context()
        if isinstance(according, str):
            according = According.parse(according)
        self.region = ATRegion(
            at_type=at_type, feature="select", name=name,
            params=_coerce_params(params), according=according,
            search=search, number=number, metadata=metadata or {})
        self._parent = parent
        self._registered = False

    def alternative(self, according: According | str | None = None,
                    name: str = "") -> Callable:
        if isinstance(according, str):
            according = According.parse(according)

        def deco(fn: Callable) -> Callable:
            self.region.subregions.append(
                Subregion(fn=fn, according=according,
                          name=name or fn.__name__))
            return fn

        return deco

    def finalize(self) -> ATRegion:
        if not self._registered:
            if self._parent is not None:
                self._parent.add_child(self.region)
                self.ctx.registry.register(self.region)
            else:
                self.ctx.register(self.region)
            self._registered = True
        return self.region

    def __call__(self, *args, **kwargs) -> Any:
        """Invoke the (possibly still-tuning) region through the runtime."""
        return self.ctx.execute(self.region.name, *args, **kwargs)


def static_select(ctx=None, **kw) -> SelectRegion:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sel = SelectRegion(ctx, "static", kw.pop("name"), **kw)
    _warn_deprecated("static_select",
                     "AutoTuner.autotune('static', 'select', name=...)")
    return sel


def dynamic_select(ctx=None, **kw) -> SelectRegion:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sel = SelectRegion(ctx, "dynamic", kw.pop("name"), **kw)
    _warn_deprecated("dynamic_select",
                     "AutoTuner.autotune('dynamic', 'select', name=...)")
    return sel


def install_select(ctx=None, **kw) -> SelectRegion:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sel = SelectRegion(ctx, "install", kw.pop("name"), **kw)
    _warn_deprecated("install_select",
                     "AutoTuner.autotune('install', 'select', name=...)")
    return sel
