"""Constants shared by every module of the port."""

from . import constants  # noqa: F401
