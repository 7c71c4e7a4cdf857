"""Small sizes for the CPU tests: every width as configured, fewer
rows, a smaller pool and vocabulary, a short warm-up."""

SMALL = {
    "sift1m.batch4096": {"config": {"dataset": {"rows": 4000,
                                                "queries": 300}},
                         "mix": {"batch": 64, "warmup_requests": 2}},
    "fiqa.hybrid-single": {"config": {"dataset": {"rows": 3000,
                                                  "queries": 300,
                                                  "clusters": 64},
                                      "text": {"vocabulary": 2000}},
                           "mix": {"rate": 20, "warmup_requests": 5}},
}
