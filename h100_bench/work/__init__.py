"""Work counts of the yardstick, from shapes or from the reference: never
from the measured program, so that no change to it moves them."""
