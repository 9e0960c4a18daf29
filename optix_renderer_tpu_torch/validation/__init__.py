"""Statistical validation: executable <test> scene objects.

Counterpart of `optix_renderer_tpu/validation/`: the reference's ttest and
chi2test scene objects, which run when their XML is loaded
(src/utils/ttest.cpp:60-270, src/utils/chi2test.cpp:43-270), on a device.
"""

from optix_renderer_tpu_torch.validation.xmltest import TestReport, run_xml_test  # noqa: F401
