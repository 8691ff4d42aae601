"""Small scenes on which the K1c kernel (spot and area lights, the
pluggable BRDFs, roughness, motion blur) is held against its plain version.

They are the scenes of the JAX package's own kernel tests
(tests/test_megakernel.py: spot + directional at line 202, the BRDF zoo at
361, the demo scene's area light at 243, motion + roughness at 262-300),
copied here as XML text, plus ``scenes/feat_spotareaml.xml`` as Whitted and
as path tracing with a rough absorbing dielectric.  ``chip_smoke.py`` and
the port's tests both take them from ``k1c_scenes``.
"""

from __future__ import annotations

import re
from pathlib import Path

CAM = """
  <Cameras><Camera id="1">
    <Position>{pos}</Position><Gaze>{gaze}</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>{name}.png</ImageName>
  </Camera></Cameras>
"""

# tests/test_golden_features.py::test_spot_and_directional_lights, the
# scene of the JAX kernel's tests/test_megakernel.py:202
SPOT_DIR_XML = f"""<Scene>
  <BackgroundColor>8 8 16</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 1 3", gaze="0 -0.2 -1", name="spotdir")}
  <Lights>
    <AmbientLight>12 12 12</AmbientLight>
    <SpotLight id="1">
      <Position>1.5 4 -2</Position><Direction>-0.4 -1 -0.2</Direction>
      <Intensity>900 850 800</Intensity>
      <CoverageAngle>40</CoverageAngle><FalloffAngle>24</FalloffAngle>
    </SpotLight>
    <DirectionalLight id="1">
      <Direction>-0.3 -1 -0.5</Direction><Radiance>4 5 6</Radiance>
    </DirectionalLight>
  </Lights>
  <Materials>
    <Material id="1">
      <AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.65 0.6</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>40</PhongExponent>
    </Material>
    <Material id="2">
      <AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.5 0.8</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>120</PhongExponent>
    </Material>
  </Materials>
  <VertexData>
    -8 -1 4   8 -1 4   8 -1 -12   -8 -1 -12
    0 -0.3 -3
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>2</Material>
      <Center>5</Center><Radius>0.7</Radius></Sphere>
  </Objects>
</Scene>"""

# tests/test_golden_features.py::test_brdf_models_vs_reference, the scene
# of tests/test_megakernel.py:361: five spheres, one BRDF each
BRDF_XML = f"""<Scene>
  <BackgroundColor>6 6 10</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  {CAM.format(pos="0 1.2 6", gaze="0 -0.15 -1", name="brdfs")}
  <Lights>
    <AmbientLight>14 14 14</AmbientLight>
    <PointLight id="1"><Position>0 5 3</Position>
      <Intensity>1500 1450 1400</Intensity></PointLight>
  </Lights>
  <BRDFs>
    <OriginalPhong id="1"><Exponent>30</Exponent></OriginalPhong>
    <ModifiedPhong id="2" normalized="true"><Exponent>40</Exponent></ModifiedPhong>
    <OriginalBlinnPhong id="3"><Exponent>50</Exponent></OriginalBlinnPhong>
    <ModifiedBlinnPhong id="4" normalized="true"><Exponent>60</Exponent></ModifiedBlinnPhong>
    <TorranceSparrow id="5" kdfresnel="true"><Exponent>80</Exponent></TorranceSparrow>
  </BRDFs>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.55 0.55 0.55</DiffuseReflectance>
      <SpecularReflectance>0.15 0.15 0.15</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="2" BRDF="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.2 0.2</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="3" BRDF="2"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.7 0.2</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="4" BRDF="3"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.2 0.7</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="5" BRDF="4"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.2</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="6" BRDF="5"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.3 0.6</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <RefractionIndex>1.8</RefractionIndex>
      <PhongExponent>25</PhongExponent></Material>
  </Materials>
  <VertexData>
    -9 -1 6   9 -1 6   9 -1 -9   -9 -1 -9
    -4 -0.2 0   -2 -0.2 -0.7   0 -0.2 -1   2 -0.2 -0.7   4 -0.2 0
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>2</Material><Center>5</Center><Radius>0.8</Radius></Sphere>
    <Sphere id="2"><Material>3</Material><Center>6</Center><Radius>0.8</Radius></Sphere>
    <Sphere id="3"><Material>4</Material><Center>7</Center><Radius>0.8</Radius></Sphere>
    <Sphere id="4"><Material>5</Material><Center>8</Center><Radius>0.8</Radius></Sphere>
    <Sphere id="5"><Material>6</Material><Center>9</Center><Radius>0.8</Radius></Sphere>
  </Objects>
</Scene>"""

# the JAX package's demo scene (__graft_entry__.py::_demo_scene_xml, the
# scene of tests/test_megakernel.py:243): a floor, a mirror and an
# absorbing glass sphere under a point light and a square area light
AREA_DEMO_XML = """
<Scene>
  <MaxRecursionDepth>4</MaxRecursionDepth>
  <BackgroundColor>10 10 20</BackgroundColor>
  <Cameras>
    <Camera id="1">
      <Position>0 1 4</Position><Gaze>0 -0.1 -1</Gaze><Up>0 1 0</Up>
      <NearPlane>-1 1 -1 1</NearPlane><NearDistance>1</NearDistance>
      <ImageResolution>64 64</ImageResolution><ImageName>demo.png</ImageName>
    </Camera>
  </Cameras>
  <Lights>
    <AmbientLight>10 10 10</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>600 600 600</Intensity></PointLight>
    <AreaLight id="1"><Position>0 4 0</Position><Normal>0 -1 0</Normal>
      <Radiance>30 30 30</Radiance><Size>1.5</Size></AreaLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.6</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>20</PhongExponent></Material>
    <Material id="2" type="mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.1 0.05 0.05</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.9 0.9 0.9</MirrorReflectance></Material>
    <Material id="3" type="dielectric"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0 0 0</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <RefractionIndex>1.5</RefractionIndex>
      <AbsorptionCoefficient>0.05 0.02 0.01</AbsorptionCoefficient></Material>
  </Materials>
  <VertexData>
    -5 0 -5   5 0 -5   5 0 5   -5 0 5   -0.9 0.7 0   0.9 0.7 0
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 3 2 1 4 3</Faces></Mesh>
    <Sphere id="1"><Material>2</Material><Center>5</Center>
      <Radius>0.7</Radius></Sphere>
    <Sphere id="2"><Material>3</Material><Center>6</Center>
      <Radius>0.7</Radius></Sphere>
  </Objects>
</Scene>
"""

# the scene of tests/test_megakernel.py:262-300: a moving floor, a rough
# mirror sphere and a moving diffuse sphere
MOTION_ROUGH_XML = """<Scene>
  <MaxRecursionDepth>3</MaxRecursionDepth>
  <BackgroundColor>4 4 8</BackgroundColor>
  <Cameras><Camera id="1">
    <Position>0 1 4</Position><Gaze>0 -0.1 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -1 1</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>64 64</ImageResolution><ImageName>m.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>10 10 10</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>600 600 600</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.6</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>20</PhongExponent></Material>
    <Material id="2" type="mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.1 0.1 0.1</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.9 0.9 0.9</MirrorReflectance>
      <Roughness>0.15</Roughness></Material>
  </Materials>
  <VertexData>
    -5 0 -5   5 0 -5   5 0 5   -5 0 5   -0.9 0.7 0   0.9 0.7 0
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 3 2 1 4 3</Faces>
      <MotionBlur>0.6 0 0</MotionBlur></Mesh>
    <Sphere id="1"><Material>2</Material><Center>5</Center>
      <Radius>0.7</Radius></Sphere>
    <Sphere id="2"><Material>1</Material><Center>6</Center>
      <Radius>0.7</Radius><MotionBlur>0 0.8 0</MotionBlur></Sphere>
  </Objects>
</Scene>"""

ROUGH_GLASS = """<Material id="2" type="dielectric">
      <AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0 0 0</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <RefractionIndex>1.5</RefractionIndex>
      <AbsorptionCoefficient>0.05 0.02 0.01</AbsorptionCoefficient>
      <Roughness>0.1</Roughness>
    </Material>"""
PT_PARAMS = ("<Renderer>PathTracing</Renderer><RendererParams>"
             "NextEventEstimation ImportanceSampling</RendererParams>")


def path_traced(xml: str) -> str:
    """A scene's XML with its camera switched to path tracing with NEE and
    importance sampling."""
    return xml.replace("</ImageName>", "</ImageName>" + PT_PARAMS)


def spotareaml_pt_xml(xml: str) -> str:
    """``scenes/feat_spotareaml.xml`` (its text ``xml``) path traced, its
    mirror sphere made a rough absorbing dielectric."""
    xml = re.sub(r'<Material id="2" type="Mirror">.*?</Material>', ROUGH_GLASS,
                 xml, flags=re.S)
    return path_traced(xml)


def k1c_scenes(scenes_dir: Path) -> dict:
    """name -> XML of the K1c checks' scenes: the four of the JAX kernel's
    tests and ``feat_spotareaml.xml`` (read from ``scenes_dir``) as Whitted
    and as path tracing with a rough dielectric."""
    spotareaml = (Path(scenes_dir) / "feat_spotareaml.xml").read_text()
    return {
        "spot_dir": SPOT_DIR_XML,
        "brdf_zoo": BRDF_XML,
        "area_demo": AREA_DEMO_XML,
        "motion_rough": MOTION_ROUGH_XML,
        "spotareaml": spotareaml,
        "spotareaml_pt_rough_glass": spotareaml_pt_xml(spotareaml),
    }
