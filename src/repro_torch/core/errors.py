"""ppOpen-AT error model.

The paper (§3.2) specifies that violating the install -> static -> dynamic
execution priority generates an *error code* and halts auto-tuning.  We keep
numeric codes so the behaviour is observable/testable the way the paper
describes it, while still raising real Python exceptions.
"""
from __future__ import annotations


class OATError(RuntimeError):
    """Base error for the auto-tuning system.  Carries a numeric code."""

    code: int = 1

    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class OATPriorityError(OATError):
    """Execution priority violation (paper §3.2).

    e.g. running before-execute-time AT before install-time AT completed.
    """

    code = 10


class OATMissingBasicParamError(OATError):
    """Before execute-time AT requires the basic parameters to be set
    (paper §4.2.2: "before execute-time auto tuning will not run if the
    basic parameters are not set")."""

    code = 11


class OATParamCollisionError(OATError):
    """Parameter collision (paper §6.3): auto tuning attempted on a parameter
    pinned by a user specification file.  AT halts for that region and the
    user value is force-set.  This exception is raised only when the caller
    asks for strict behaviour; the default runtime path records the collision
    and force-sets the value as the paper specifies."""

    code = 12


class OATHierarchyError(OATError):
    """Parameter-visibility violation (paper Fig. 4): e.g. an install-time
    routine reading a parameter determined at run-time."""

    code = 13


class OATNestingError(OATError):
    """Illegal nesting (paper §6.4.1, Tables 1 and 2), e.g. `unroll` nesting
    another feature, or `install` nesting `static`; or nesting depth > 3."""

    code = 14


class OATSpecError(OATError):
    """Malformed directive / specifier / subtype specifier."""

    code = 15


class OATCodegenError(OATError):
    """Code generation failed (unsupported construct inside an AT region)."""

    code = 16
