"""Framework-wide error taxonomy.

`UserError` marks failures caused by user input — bad flag values, malformed
files, out-of-range controls — as opposed to internal bugs.  The CLI turns
only these into clean one-line exits; internal errors keep their tracebacks.

Subclasses ValueError so library callers that catch ValueError keep working.
"""


class UserError(ValueError):
    """A failure attributable to user input, not a framework bug."""
