"""The comparisons that decide a run's `correct`, one module a driver."""

# The plain reference's rows at a time: it runs once the window has
# closed, in blocks, so that it fits in the card's memory beside the
# program's freed state.
REFERENCE_ROWS = 4
