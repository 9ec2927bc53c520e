from . import hostmath
from .timing import TimeTable
