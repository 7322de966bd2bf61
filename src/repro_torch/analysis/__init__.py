"""Analysis tools of the port: the continuous engine's runtime sanitizer
(``analysis.sanitize``)."""
