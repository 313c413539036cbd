from .log import Log
from .random import Random
