"""Small scenes on which the K1c kernel (spot and area lights, the
pluggable BRDFs, roughness, motion blur) and the K1d kernel (textures and
the environment light) are held against their plain version.

They are the scenes of the JAX package's own kernel tests
(tests/test_megakernel.py: spot + directional at line 202, the BRDF zoo at
361, the demo scene's area light at 243, motion + roughness at 262-300;
Perlin textures at 403, image textures at 600, normal and bump maps at
916, six textures at 1060, megapixel and HDR textures at 1152-1174, the
background texture at 1261, sphere textures at 1338, transformed maps at
1431, the sphere Perlin bump at 1558, the env light at 781 and 1227),
copied here as XML text with writers for their image assets, plus
``scenes/feat_spotareaml.xml`` as Whitted and as path tracing with a rough
absorbing dielectric.  ``chip_smoke.py`` and the port's tests both take
them from ``k1c_scenes`` and ``k1d_scenes``; ``write_feature_textures``
makes the committed assets of ``scenes/feat_textures.xml``.

``torus_mesh`` makes the torus of ``scenes/whitted_conductors_mesh.ply``
(and the coarse one of the CPU tests), and ``gauge_scene_xml`` writes the
scene of the differentiable path (slice C1): that room with a directional
anchor light.  The differentiable textures (slice C3) take
``texture_inverse_scene_xml`` (the JAX tools/inverse_render.py's texture
scene), ``tex_bwd_scene_xml`` (the JAX texture-gradient test's two
textures and mirror sphere) and ``textured_pt_scene_xml``
(``scenes/feat_pt.xml`` with a textured floor); each writes its XML and
images at run time into a directory the caller gives.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path

import numpy as np

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


# ---------------------------------------------------------------------------
# K1d: textures and the environment light
# ---------------------------------------------------------------------------

TEX_CAM = CAM.format(pos="0 1.2 4", gaze="0 -0.25 -1", name="{name}")

_MATS3 = """<Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.5 0.4</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="2"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.4 0.8</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>60</PhongExponent></Material>
    <Material id="3" type="mirror"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.1 0.1 0.1</DiffuseReflectance>
      <SpecularReflectance>0.1 0.1 0.1</SpecularReflectance>
      <MirrorReflectance>0.9 0.9 0.9</MirrorReflectance>
      <PhongExponent>5</PhongExponent></Material>
  </Materials>"""

_LIGHTS = """<Lights>
    <AmbientLight>25 25 25</AmbientLight>
    <PointLight id="1"><Position>2 4 2</Position>
      <Intensity>900 900 900</Intensity></PointLight>
  </Lights>"""

_QUADS = """<VertexData>
    -8 -1 4   8 -1 4   8 -1 -12   -8 -1 -12
    -8 -1 -6   8 -1 -6   8 7 -6   -8 7 -6
    -3 -1 1   -1 -1 1   -1 1 1    -3 1 1
    1 -1 0.5   3 -1 0.5   3 1 0.5   1 1 0.5
  </VertexData>"""

# tests/test_megakernel.py:403: Perlin replace_kd (absval), blend_kd
# (linear), bump_normal and replace_ks, a mirror bouncing onto the floor
PERLIN_XML = f"""<Scene>
  <BackgroundColor>4 4 8</BackgroundColor>
  <MaxRecursionDepth>3</MaxRecursionDepth>
  <ShadowRayEpsilon>1e-3</ShadowRayEpsilon>
  {TEX_CAM.format(name="megaperlin")}
  {_LIGHTS}
  {_MATS3}
  <Textures>
    <TextureMap id="1" type="perlin">
      <DecalMode>replace_kd</DecalMode>
      <NoiseConversion>absval</NoiseConversion>
      <NoiseScale>3</NoiseScale>
    </TextureMap>
    <TextureMap id="2" type="perlin">
      <DecalMode>blend_kd</DecalMode>
      <NoiseConversion>linear</NoiseConversion>
      <NoiseScale>1.5</NoiseScale>
    </TextureMap>
    <TextureMap id="3" type="perlin">
      <DecalMode>bump_normal</DecalMode>
      <NoiseConversion>linear</NoiseConversion>
      <NoiseScale>2.2</NoiseScale>
      <BumpFactor>3</BumpFactor>
    </TextureMap>
    <TextureMap id="4" type="perlin">
      <DecalMode>replace_ks</DecalMode>
      <NoiseConversion>absval</NoiseConversion>
      <NoiseScale>4</NoiseScale>
    </TextureMap>
  </Textures>
  {_QUADS}
  <TexCoordData>
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1 3</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>2</Material><Textures>2 4</Textures>
      <Faces>5 6 7  5 7 8</Faces></Mesh>
    <Mesh id="3"><Material>3</Material>
      <Faces>9 10 11  9 11 12</Faces></Mesh>
    <Mesh id="4"><Material>2</Material><Textures>2</Textures>
      <Faces>13 14 15  13 15 16</Faces></Mesh>
  </Objects>
</Scene>"""

# tests/test_megakernel.py:600: nearest replace_kd with UVs tiled 0..3,
# bilinear blend_kd and replace_ks, a Perlin replace_kd beside an image
# replace_ks on one mesh, UVs below 0 and above 1
IMAGE_XML = f"""<Scene>
  <BackgroundColor>6 6 10</BackgroundColor>
  <MaxRecursionDepth>3</MaxRecursionDepth>
  <ShadowRayEpsilon>1e-3</ShadowRayEpsilon>
  {TEX_CAM.format(name="megaimage")}
  {_LIGHTS}
  {_MATS3}
  <Textures>
    <Images>
      <Image id="1">{{img1}}</Image>
      <Image id="2">{{img2}}</Image>
    </Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="image">
      <DecalMode>blend_kd</DecalMode><ImageId>2</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
    <TextureMap id="3" type="image">
      <DecalMode>replace_ks</DecalMode><ImageId>2</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
    <TextureMap id="4" type="perlin">
      <DecalMode>replace_kd</DecalMode>
      <NoiseConversion>absval</NoiseConversion>
      <NoiseScale>3</NoiseScale>
    </TextureMap>
  </Textures>
  {_QUADS}
  <TexCoordData>
    0 3   3 3   3 0   0 0
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
    -0.25 1.3   1.3 1.3   1.3 -0.25   -0.25 -0.25
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>2</Material><Textures>2 3</Textures>
      <Faces>5 6 7  5 7 8</Faces></Mesh>
    <Mesh id="3"><Material>3</Material>
      <Faces>9 10 11  9 11 12</Faces></Mesh>
    <Mesh id="4"><Material>2</Material><Textures>3 4</Textures>
      <Faces>13 14 15  13 15 16</Faces></Mesh>
  </Objects>
</Scene>"""

# tests/test_megakernel.py:916: a nearest normal map, an image bump and a
# bilinear replace_all
MAPS_XML = f"""<Scene>
  <BackgroundColor>6 6 10</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <ShadowRayEpsilon>1e-3</ShadowRayEpsilon>
  {TEX_CAM.format(name="megamaps")}
  {_LIGHTS}
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.7 0.5 0.4</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>25</PhongExponent></Material>
    <Material id="2"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.2 0.4 0.8</DiffuseReflectance>
      <SpecularReflectance>0.5 0.5 0.5</SpecularReflectance>
      <PhongExponent>60</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images>
      <Image id="1">{{img1}}</Image>
      <Image id="2">{{img2}}</Image>
    </Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_normal</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="image">
      <DecalMode>bump_normal</DecalMode><ImageId>2</ImageId>
      <Interpolation>nearest</Interpolation>
      <BumpFactor>2.5</BumpFactor>
    </TextureMap>
    <TextureMap id="3" type="image">
      <DecalMode>replace_all</DecalMode><ImageId>2</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -8 -1 4   8 -1 4   8 -1 -12   -8 -1 -12
    -3 -1 1   -1 -1 1   -1 1 1    -3 1 1
    1 -1 0.5   3 -1 0.5   3 1 0.5   1 1 0.5
  </VertexData>
  <TexCoordData>
    0 3   3 3   3 0   0 0
    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material>
      <Textures>2</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>2</Material>
      <Textures>1</Textures>
      <Faces vertexOffset="4" textureOffset="4">1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="3"><Material>2</Material>
      <Textures>3</Textures>
      <Faces vertexOffset="8" textureOffset="8">1 2 3  1 3 4</Faces></Mesh>
  </Objects>
</Scene>"""

# tests/test_megakernel.py:1261: a replace_background texture around a
# centred quad
BG_XML = """<Scene>
  <BackgroundColor>9 9 9</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 0 3</Position><Gaze>0 0 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>bg.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>0 2 3</Position>
      <Intensity>300 300 300</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.5 0.4 0.3</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>12</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images><Image id="1">{img}</Image></Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_background</DecalMode><ImageId>1</ImageId>
      <Interpolation>{interp}</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -0.6 -0.6 0   0.6 -0.6 0   0.6 0.6 0   -0.6 0.6 0
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 2 3  1 3 4</Faces></Mesh>
  </Objects>
</Scene>"""

# tests/test_megakernel.py:1338: an image texture through spherical UV
# beside a Perlin replace_ks on one sphere
SPHERE_TEX_XML = """<Scene>
  <BackgroundColor>2 2 2</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 0 3</Position><Gaze>0 0 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>stex.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>2 3 3</Position>
      <Intensity>500 500 500</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.5 0.4 0.3</DiffuseReflectance>
      <SpecularReflectance>0.3 0.3 0.3</SpecularReflectance>
      <PhongExponent>15</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images><Image id="1">{img}</Image></Images>
    <TextureMap id="1" type="image">
      <DecalMode>{decal}</DecalMode><ImageId>1</ImageId>
      <Interpolation>{interp}</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="perlin">
      <DecalMode>replace_ks</DecalMode>
      <NoiseScale>4</NoiseScale>
      <NoiseConversion>absval</NoiseConversion>
    </TextureMap>
  </Textures>
  <VertexData>
    0 0 0   -2 -1.2 -1   2 -1.2 -1   0 1.4 -1
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material>
      <Faces>2 3 4</Faces></Mesh>
    <Sphere id="1"><Material>1</Material><Textures>{tex}</Textures>
      <Center>1</Center><Radius>0.8</Radius></Sphere>
  </Objects>
</Scene>"""


def env_xml(image: str = "env.exr", mirror: bool = True,
            roughness: float | None = None) -> str:
    """tests/test_megakernel.py:781: a floor and a mirror sphere under a
    SphericalDirectionalLight (mirror children see the env on a miss);
    with ``roughness`` the mirror is rough (the env's 48 draw slots then
    sit below the roughness pair's)."""
    rough = ("" if roughness is None
             else f"<Roughness>{roughness}</Roughness>")
    sphere = """<Sphere id="1"><Material>2</Material><Center>5</Center>
      <Radius>1.0</Radius></Sphere>""" if mirror else ""
    return f"""<Scene>
  <BackgroundColor>0 0 0</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 1 4</Position><Gaze>0 -0.1 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>t.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>5 5 5</AmbientLight>
    <SphericalDirectionalLight id="1"><ImageId>1</ImageId>
    </SphericalDirectionalLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.6 0.6 0.6</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>20</PhongExponent></Material>
    <Material id="2" type="Mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.1 0.1 0.1</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.9 0.9 0.9</MirrorReflectance>
      <PhongExponent>1</PhongExponent>{rough}</Material>
  </Materials>
  <Textures><Images><Image id="1">{image}</Image></Images></Textures>
  <VertexData>
    -6 -1 4   6 -1 4   6 -1 -8   -6 -1 -8
    0 0 -2
  </VertexData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Faces>1 2 3  1 3 4</Faces></Mesh>
    {sphere}
  </Objects>
</Scene>"""


# mesh and area lights of env_aligned_xml by the env draws' first slot mod
# 4: base_env = 3 + 3 n_ml + 2 n_area (ops/rng.py's slot layout) is 8, 5,
# 6 and 7, so the 48 env draws start at each word of a Philox block
ENV_ALIGNED_LIGHTS = {0: (1, 1), 1: (0, 1), 2: (1, 0), 3: (0, 2)}


def env_aligned_xml(align: int, image: str = "env64x32.exr") -> str:
    """``env_xml`` with a rough mirror and the mesh and area lights of
    ``ENV_ALIGNED_LIGHTS[align]``: its env candidates' draws start at word
    ``align`` of a Philox block, its roughness pair above them."""
    n_ml, n_area = ENV_ALIGNED_LIGHTS[align]
    xml = env_xml(image, roughness=0.2)
    areas = "".join(
        f"""<AreaLight id="{a + 1}"><Position>{3.0 * a - 1.5} 3 1</Position>
      <Normal>0 -1 0</Normal><Size>1</Size><Radiance>40 38 36</Radiance>
    </AreaLight>""" for a in range(n_area))
    xml = xml.replace("</Lights>", areas + "</Lights>")
    if n_ml:
        xml = xml.replace("</Materials>", """<Material id="3">
      <AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0 0 0</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <PhongExponent>1</PhongExponent></Material>
  </Materials>""")
        xml = xml.replace("    0 0 -2\n", """    0 0 -2
    -0.5 2.5 0.5   0.5 2.5 0.5   0.5 2.5 -0.5   -0.5 2.5 -0.5
""")
        xml = xml.replace("  </Objects>", """    <LightMesh id="2"><Material>3</Material>
      <Radiance>20 19 18</Radiance><Faces>6 7 8  6 8 9</Faces></LightMesh>
  </Objects>""")
    return xml


def write_random_png(path, w: int, h: int, seed: int) -> None:
    """Uniform random LDR texels from a seed (the JAX tests'
    ``_write_test_png``)."""
    from advanced_cpu_raytracing_tpu_torch.scene.images import write_png

    write_png(str(path), np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), dtype=np.uint8))


def env_map(w: int = 64, h: int = 32) -> np.ndarray:
    """The JAX env test's lat-long map: ramps in x and y, a bright band."""
    ys, xs = np.mgrid[0:h, 0:w]
    return np.stack([1.0 + 3.0 * xs / w, 0.5 + 2.0 * ys / h,
                     2.0 + np.where((ys > 8) & (ys < 14), 6.0, 0.0)],
                    axis=-1).astype(np.float32)


def checkerboard_png(path, n: int = 8, cell: int = 4) -> None:
    """tests/scene_builders.py:13-20: an n x n checkerboard of cell-pixel
    squares, yellow-ish and blue-ish."""
    from advanced_cpu_raytracing_tpu_torch.scene.images import write_png

    size = n * cell
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((yy // cell + xx // cell) % 2).astype(np.uint8)
    write_png(str(path), np.stack([mask * 255, mask * 255,
                                   np.full_like(mask, 128)], axis=-1))


def gradient_map(w: int = 64, h: int = 32) -> np.ndarray:
    """tests/scene_builders.py:23-32: a lat-long map bright near the +y
    pole, dark at -y."""
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 2.0 * (1 - v)
    img[..., 1] = 1.0
    img[..., 2] = 2.0 * v
    return img


def _six_textures(xml: str) -> str:
    """IMAGE_XML grown to six maps (tests/test_megakernel.py:1060): a
    Perlin bump beside the floor's image, an image blend on the mirror."""
    xml = xml.replace(
        """    <TextureMap id="4" type="perlin">""",
        """    <TextureMap id="5" type="perlin">
      <DecalMode>bump_normal</DecalMode>
      <NoiseConversion>linear</NoiseConversion>
      <NoiseScale>2</NoiseScale>
      <BumpFactor>0.5</BumpFactor>
    </TextureMap>
    <TextureMap id="6" type="image">
      <DecalMode>blend_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="4" type="perlin">""")
    xml = xml.replace(
        '<Mesh id="3"><Material>3</Material>\n      <Faces>9 10 11  9 11 12</Faces></Mesh>',
        '<Mesh id="3"><Material>3</Material><Textures>6</Textures>\n'
        '      <Faces>9 10 11  9 11 12</Faces></Mesh>')
    return xml.replace("<Textures>1</Textures>", "<Textures>1 5</Textures>")


def _transformed_maps(xml: str) -> str:
    """MAPS_XML with a non-uniform scale on the bump floor and a rotation
    on the normal-mapped wall (tests/test_megakernel.py:1431)."""
    xml = xml.replace("<Objects>", """<Transformations>
    <Scaling id="1">1.4 0.8 1.1</Scaling>
    <Rotation id="1">25 0 1 0</Rotation>
  </Transformations>
  <Objects>""")
    xml = xml.replace('<Mesh id="1"><Material>1</Material>',
                      '<Mesh id="1"><Material>1</Material>'
                      '<Transformations>s1</Transformations>')
    return xml.replace('<Mesh id="2"><Material>2</Material>',
                       '<Mesh id="2"><Material>2</Material>'
                       '<Transformations>r1</Transformations>')


# the K1d scenes that draw randoms (the env light's candidates)
K1D_SAMPLED = {"env", "env_big", "env_rough", "env_motion_rough",
               "spotareaml_env", "spotareaml_env_pt_rough_glass"}


def with_env(xml: str, image: str) -> str:
    """A scene's XML with a SphericalDirectionalLight on ``image`` added
    (the scene must have no <Textures> of its own)."""
    return xml.replace(
        "</Lights>", "<SphericalDirectionalLight id=\"1\"><ImageId>1"
        "</ImageId></SphericalDirectionalLight></Lights>"
        f"<Textures><Images><Image id=\"1\">{image}</Image></Images></Textures>")


def k1d_scenes(asset_dir, scenes_dir=None) -> dict:
    """name -> XML of the K1d checks' scenes, their image assets written
    into ``asset_dir`` (the XML names them relative to it: write the XML
    there too).  With ``scenes_dir`` (the repo's scenes/), also
    ``feat_spotareaml.xml`` under the env light, as Whitted and as path
    tracing with a rough glass sphere: every light kind's draw slots below
    the env's, and the roughness pair above them."""
    from advanced_cpu_raytracing_tpu_torch.scene.images import write_exr, write_hdr

    d = Path(asset_dir)
    d.mkdir(parents=True, exist_ok=True)
    pngs = {"t16.png": (16, 16, 3), "t33x7.png": (33, 7, 4),
            "nm16.png": (16, 16, 5), "bump33x7.png": (33, 7, 6),
            "big164x127.png": (164, 127, 3), "big150x110.png": (150, 110, 4),
            "bg37x23.png": (37, 23, 8), "stex48x31.png": (48, 31, 9),
            "stex16.png": (16, 16, 9)}
    for name, (w, h, seed) in pngs.items():
        write_random_png(d / name, w, h, seed)
    write_exr(str(d / "hdr40x30.exr"), np.random.default_rng(9).uniform(
        0.0, 400.0, (30, 40, 3)).astype(np.float32))
    write_exr(str(d / "env64x32.exr"), env_map(64, 32))
    write_exr(str(d / "env200x100.exr"), env_map(200, 100))
    checkerboard_png(d / "checker32.png")
    write_hdr(str(d / "gradient64x32.hdr"), gradient_map())

    scenes = {
        "perlin": PERLIN_XML,
        "image": IMAGE_XML.format(img1="t16.png", img2="t33x7.png"),
        "maps": MAPS_XML.format(img1="nm16.png", img2="bump33x7.png"),
        "six_textures": _six_textures(IMAGE_XML.format(img1="t16.png",
                                                       img2="t33x7.png")),
        "big_nearest": IMAGE_XML.format(img1="big164x127.png", img2="t33x7.png"),
        "big_bilinear": IMAGE_XML.format(img1="t16.png", img2="big150x110.png"),
        "hdr_texture": IMAGE_XML.format(img1="hdr40x30.exr", img2="t33x7.png"),
        "bg_nearest": BG_XML.format(img="bg37x23.png", interp="nearest"),
        "bg_bilinear": BG_XML.format(img="bg37x23.png", interp="bilinear"),
        "transformed_maps": _transformed_maps(
            MAPS_XML.format(img1="nm16.png", img2="bump33x7.png")),
        "sphere_perlin_bump": SPHERE_TEX_XML.format(
            img="stex16.png", decal="replace_kd", interp="nearest",
            tex="1 2").replace("<DecalMode>replace_ks</DecalMode>",
                               "<DecalMode>bump_normal</DecalMode>"),
        "env": env_xml("env64x32.exr"),
        "env_big": env_xml("env200x100.exr"),
        "env_rough": env_xml("env64x32.exr", roughness=0.2),
        # the env light with motion (the K1d motion instantiation): the
        # roughness pair above the env's 48 slots, the motion time last
        "env_motion_rough": with_env(MOTION_ROUGH_XML, "env64x32.exr"),
    }
    for decal, interp, tex in (("replace_kd", "nearest", "1 2"),
                               ("blend_kd", "bilinear", "1"),
                               ("replace_all", "bilinear", "1"),
                               ("bump_normal", "nearest", "1")):
        # the bump reads the checkerboard: steps of the height field
        img = "checker32.png" if decal == "bump_normal" else "stex48x31.png"
        scenes[f"sphere_{decal}"] = SPHERE_TEX_XML.format(
            img=img, decal=decal, interp=interp, tex=tex)
    if scenes_dir is not None:
        spotareaml = (Path(scenes_dir) / "feat_spotareaml.xml").read_text()
        scenes["spotareaml_env"] = with_env(spotareaml, "gradient64x32.hdr")
        scenes["spotareaml_env_pt_rough_glass"] = with_env(
            spotareaml_pt_xml(spotareaml), "gradient64x32.hdr")
    return scenes


# ---------------------------------------------------------------------------
# the assets of scenes/feat_textures.xml (committed under scenes/textures/)
# ---------------------------------------------------------------------------


def _bricks(w: int, h: int, bw: int = 128, bh: int = 64):
    """Per texel: (brick row, brick column, x within the brick, y within
    it) of a running-bond brick wall, rows offset by half a brick."""
    yy, xx = np.mgrid[0:h, 0:w]
    row = yy // bh
    xs = xx + (row % 2) * (bw // 2)
    return row, xs // bw, xs % bw, yy % bh


def feature_texture_images() -> dict:
    """file name -> (H,W,3) array of the main-path scene's textures, made
    deterministically: a 1024x1024 tile floor (uint8), a 1024x1024 brick
    normal map (uint8, replace_normal and replace_kd of the back wall), a
    1024x1024 brick height map (uint8 grey, the left wall's bump), a
    1024x512 lat-long checker for the sphere (uint8) and a 1024x512 HDR sky
    (float32) for the SphericalDirectionalLight."""
    rng = np.random.default_rng(2024)
    # floor: 16 x 16 tiles of 64 px from a 24-colour palette, dark grout
    palette = rng.integers(40, 256, (24, 3))
    ty, tx = np.mgrid[0:1024, 0:1024] // 64
    floor = palette[rng.integers(0, 24, (16, 16))[ty, tx]]
    yy, xx = np.mgrid[0:1024, 0:1024]
    floor[((yy % 64) < 4) | ((xx % 64) < 4)] = (30, 28, 26)
    # bricks: bevelled edges as constant normals, flat faces, mortar
    row, _, bx, by = _bricks(1024, 1024)
    nrm = np.zeros((1024, 1024, 3), np.float32)
    nrm[..., 2] = 1.0
    bev, s = 10, 0.6
    for mask, (nx, ny) in (((bx < bev), (-s, 0.0)), ((bx >= 128 - bev), (s, 0.0)),
                           ((by < bev), (0.0, s)), ((by >= 64 - bev), (0.0, -s))):
        nrm[mask] = (nx, ny, np.sqrt(1.0 - s * s))
    mortar = (bx < 3) | (by < 3)
    nrm[mortar] = (0.0, 0.0, 1.0)
    normal = np.clip(np.round(nrm * 127.5 + 127.5), 0, 255)
    height = np.where(mortar, 40, 40 + np.minimum(np.minimum(bx, 127 - bx),
                                                  np.minimum(by, 63 - by))
                      .clip(0, 12) * 15)
    # sphere: a 32 x 16 lat-long checker of two colours
    sy, sx = np.mgrid[0:512, 0:1024]
    check = ((sy // 32 + sx // 32) % 2)[..., None]
    sphere = np.where(check, (230, 190, 60), (40, 90, 200))
    # sky: zenith blue to a warm horizon, a dim ground, one small sun
    v = (np.arange(512, dtype=np.float32) + 0.5) / 512.0
    u = (np.arange(1024, dtype=np.float32) + 0.5) / 1024.0
    sky = np.zeros((512, 1024, 3), np.float32)
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None, None]
    sky[:] = (up * np.float32([4.0, 7.0, 14.0])
              + (1.0 - up) * np.float32([12.0, 9.0, 6.0]))
    sky[256:] = np.float32([2.0, 1.8, 1.5])
    sun = ((u[None, :] - 0.3) ** 2 * 4.0 + (v[:, None] - 0.2) ** 2) < 0.0004
    sky[sun] = (300.0, 280.0, 240.0)
    return {"floor_tiles.png": floor.astype(np.uint8),
            "brick_normal.png": normal.astype(np.uint8),
            "brick_height.png": np.repeat(height[..., None], 3, -1).astype(np.uint8),
            "sphere_checker.png": sphere.astype(np.uint8),
            "sky.hdr": sky}


def write_feature_textures(out_dir) -> None:
    """Write ``feature_texture_images`` into ``out_dir`` (PNG and flat
    RGBE .hdr)."""
    from advanced_cpu_raytracing_tpu_torch.scene.images import write_hdr, write_png

    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    for name, img in feature_texture_images().items():
        if name.endswith(".hdr"):
            write_hdr(str(d / name), img)
        else:
            write_png(str(d / name), img)


# ---------------------------------------------------------------------------
# the slice scene's torus, and the scene of the differentiable path
# ---------------------------------------------------------------------------

# full-size torus of the committed mesh, and the coarse one of the CPU tests
FULL_TORUS = dict(n_major=128, n_minor=128)
COARSE_TORUS = dict(n_major=24, n_minor=16)


def torus_mesh(n_major: int, n_minor: int, major: float = 3.5,
               minor: float = 1.2, center=(4.0, 1.5, -5.0),
               tilt_x_deg: float = 70.0, tilt_y_deg: float = 25.0):
    """A torus in world coordinates: (verts (V,3) f32, faces (F,3) i32),
    two triangles per (major, minor) cell, counter-clockwise seen from
    outside."""
    u = np.arange(n_major) * (2.0 * np.pi / n_major)
    v = np.arange(n_minor) * (2.0 * np.pi / n_minor)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = major + minor * np.cos(vv)
    pts = np.stack([ring * np.cos(uu), minor * np.sin(vv),
                    ring * np.sin(uu)], axis=-1).reshape(-1, 3)
    ax, ay = np.deg2rad(tilt_x_deg), np.deg2rad(tilt_y_deg)
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    pts = pts @ (ry @ rx).T + np.asarray(center)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    a = i * n_minor + j
    b = ((i + 1) % n_major) * n_minor + j
    c = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
    e = i * n_minor + (j + 1) % n_minor
    faces = np.concatenate([np.stack([a, e, c], -1).reshape(-1, 3),
                            np.stack([a, c, b], -1).reshape(-1, 3)])
    return pts.astype(np.float32), faces.astype(np.int32)


def ply_bytes(verts: np.ndarray, faces: np.ndarray) -> bytes:
    """Binary little-endian PLY of float32 vertices and triangle faces."""
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n").encode()
    rows = np.zeros(len(faces), dtype=[("n", "u1"), ("i", "<i4", 3)])
    rows["n"] = 3
    rows["i"] = faces
    return head + verts.astype("<f4").tobytes() + rows.tobytes()


# The anchor light of the gauge scene.  JAX's tools/inverse_render.py
# (gauge_broken_scene) adds a directional light of known radiance to its
# scene so that diffuse shading no longer constrains only the product kd *
# intensity.  The room of whitted_conductors.xml is closed above, so the
# light comes in through its open front (+z), and its radiance is of the
# order of the point lights' irradiance there (40000 / ~250).
GAUGE_ANCHOR = """<DirectionalLight id="1">
      <Direction>0.35 -0.3 -1</Direction>
      <Radiance>150 150 150</Radiance>
    </DirectionalLight>
  """
GAUGE_MIRROR = """<Material id="5" type="mirror">
      <AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.05 0.05 0.05</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <MirrorReflectance>0.8 0.8 0.8</MirrorReflectance>
      <PhongExponent>100</PhongExponent></Material>"""


def gauge_scene_xml(out_dir, scenes_dir, coarse: bool = False,
                    glass: bool = True) -> str:
    """``scenes_dir/whitted_conductors.xml`` plus a directional anchor
    light (``GAUGE_ANCHOR``), the scene of the differentiable path, written
    with its torus mesh to ``out_dir``; returns the XML path.  ``coarse``
    swaps in the coarse torus (``COARSE_TORUS``: 768 faces, 778 work
    items); ``glass=False`` makes the dielectric material 5 a mirror, so
    the scene draws nothing."""
    scenes_dir, out_dir = Path(scenes_dir), Path(out_dir)
    xml = (scenes_dir / "whitted_conductors.xml").read_text()
    if "DirectionalLight" in xml:
        raise ValueError("whitted_conductors.xml has a directional light")
    xml = xml.replace("</Lights>", GAUGE_ANCHOR + "</Lights>")
    if not glass:
        xml, n = re.subn(r'<Material id="5" type="dielectric">.*?</Material>',
                         GAUGE_MIRROR, xml, flags=re.S)
        if n != 1:
            raise ValueError("whitted_conductors.xml: no dielectric material 5")
    out_dir.mkdir(parents=True, exist_ok=True)
    ply = out_dir / ("gauge_coarse_mesh.ply" if coarse else "gauge_mesh.ply")
    xml = xml.replace('plyFile="whitted_conductors_mesh.ply"',
                      f'plyFile="{ply.name}"')
    if coarse:
        ply.write_bytes(ply_bytes(*torus_mesh(**COARSE_TORUS)))
    else:
        shutil.copyfile(scenes_dir / "whitted_conductors_mesh.ply", ply)
    out = out_dir / ("gauge" + ("_coarse" if coarse else "")
                     + ("" if glass else "_mirror") + ".xml")
    out.write_text(xml)
    return str(out)


# ---- differentiable textures (slice C3) ----


def _scene_dir(out_dir) -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    return out


def inverse_texture(n: int = 64) -> np.ndarray:
    """The JAX tools/inverse_render.py texture: an n x n ramp in red, an
    8 x 8 checker in green, a ramp in blue (u8)."""
    ys, xs = np.mgrid[0:n, 0:n] / float(n)
    return np.stack([40 + 170 * xs,
                     30 + 60 * ((np.floor(xs * 8) + np.floor(ys * 8)) % 2),
                     220 * ys], axis=-1).clip(0, 255).astype(np.uint8)


def texture_inverse_scene_xml(n: int = 64, image=None, *, out_dir) -> str:
    """The scene of inverse texture recovery, a copy of the JAX
    tools/inverse_render.py::texture_scene (85-143): a bilinear
    ``replace_kd`` texture on a tilted floor quad filling most of an
    800x800 frame, a point light and ambient light, depth 2.  The texture
    is ``inverse_texture(n)``, or with ``image`` that image file (a path)
    in its place.  Written to ``out_dir``; returns the XML's path."""
    from advanced_cpu_raytracing_tpu_torch.scene.images import write_png

    out = _scene_dir(out_dir)
    if image is None:
        image = out / "tex.png"
        write_png(str(image), inverse_texture(n))
    xml = f"""<Scene>
  <BackgroundColor>5 5 5</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 3.4 3.6</Position><Gaze>0 -0.72 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -1 1</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>800 800</ImageResolution>
    <ImageName>invtex.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>20 20 20</AmbientLight>
    <PointLight id="1"><Position>1 4 2</Position>
      <Intensity>1200 1200 1200</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.5 0.5 0.5</DiffuseReflectance>
      <SpecularReflectance>0.1 0.1 0.1</SpecularReflectance>
      <PhongExponent>10</PhongExponent></Material>
  </Materials>
  <Textures>
    <Images><Image id="1">{Path(image).resolve()}</Image></Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -2.2 -0.5 1.6   2.2 -0.5 1.6   2.2 0.2 -2.8   -2.2 0.2 -2.8
  </VertexData>
  <TexCoordData>
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
  </Objects>
</Scene>"""
    path = out / "invtex.xml"
    path.write_text(xml)
    return str(path)


def shared_image_scene_xml(n: int = 8, *, out_dir) -> str:
    """The inverse-texture frame with its floor cut in two side by side
    quads that share one image, ``inverse_texture(n)``, through two
    ``replace_kd`` textures: nearest on the left, bilinear on the right,
    each over the whole image.  Neighbouring pixels then read the same
    texel of the pool through both filters.  Written to ``out_dir``;
    returns the XML's path."""
    from advanced_cpu_raytracing_tpu_torch.scene.images import write_png

    out = _scene_dir(out_dir)
    image = out / "shared.png"
    write_png(str(image), inverse_texture(n))
    xml = Path(texture_inverse_scene_xml(n, image=image, out_dir=out))
    text = xml.read_text()
    texture = text[text.index("    <TextureMap"):text.index("  </Textures>")]
    nearest = texture.replace("bilinear", "nearest")
    text = text.replace(texture, nearest + texture.replace(
        'id="1"', 'id="2"'))
    text = text.replace("""    -2.2 -0.5 1.6   2.2 -0.5 1.6   2.2 0.2 -2.8   -2.2 0.2 -2.8
""", """    -2.2 -0.5 1.6   0 -0.5 1.6   0 0.2 -2.8   -2.2 0.2 -2.8
    0 -0.5 1.6   2.2 -0.5 1.6   2.2 0.2 -2.8   0 0.2 -2.8
""")
    text = text.replace("""    0 1   1 1   1 0   0 0
""", """    0 1   1 1   1 0   0 0
    0 1   1 1   1 0   0 0
""")
    text = text.replace("""      <Faces>1 2 3  1 3 4</Faces></Mesh>
""", """      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>1</Material><Textures>2</Textures>
      <Faces>5 6 7  5 7 8</Faces></Mesh>
""")
    path = out / "shared_image.xml"
    path.write_text(text)
    return str(path)


# the JAX texture-gradient test's scene (tests/test_megabwd.py:513-567): a
# nearest replace_kd floor tiled twice, a bilinear blend_kd wall and a mirror
# sphere that shows both
TEX_BWD_XML = """<Scene>
  <BackgroundColor>2 2 2</BackgroundColor>
  <MaxRecursionDepth>2</MaxRecursionDepth>
  <Cameras><Camera id="1">
    <Position>0 0.6 3.5</Position><Gaze>0 -0.1 -1</Gaze><Up>0 1 0</Up>
    <NearPlane>-1 1 -0.75 0.75</NearPlane><NearDistance>1</NearDistance>
    <ImageResolution>320 240</ImageResolution>
    <ImageName>texbwd.png</ImageName>
  </Camera></Cameras>
  <Lights>
    <AmbientLight>15 15 15</AmbientLight>
    <PointLight id="1"><Position>1 3 3</Position>
      <Intensity>400 400 400</Intensity></PointLight>
  </Lights>
  <Materials>
    <Material id="1"><AmbientReflectance>1 1 1</AmbientReflectance>
      <DiffuseReflectance>0.5 0.4 0.3</DiffuseReflectance>
      <SpecularReflectance>0.2 0.2 0.2</SpecularReflectance>
      <PhongExponent>12</PhongExponent></Material>
    <Material id="2" type="mirror"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.05 0.05 0.05</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance>
      <MirrorReflectance>0.8 0.8 0.8</MirrorReflectance></Material>
  </Materials>
  <Textures>
    <Images>
      <Image id="1">{img1}</Image>
      <Image id="2">{img2}</Image>
    </Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>nearest</Interpolation>
    </TextureMap>
    <TextureMap id="2" type="image">
      <DecalMode>blend_kd</DecalMode><ImageId>2</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
  </Textures>
  <VertexData>
    -4 -1 3   4 -1 3   4 -1 -6   -4 -1 -6
    -2.5 -1 -2   2.5 -1 -2   2.5 2 -2   -2.5 2 -2
  </VertexData>
  <TexCoordData>
    0 2   2 2   2 0   0 0
    0 1   1 1   1 0   0 0
  </TexCoordData>
  <Objects>
    <Mesh id="1"><Material>1</Material><Textures>1</Textures>
      <Faces>1 2 3  1 3 4</Faces></Mesh>
    <Mesh id="2"><Material>1</Material><Textures>2</Textures>
      <Faces vertexOffset="4" textureOffset="4">1 2 3  1 3 4</Faces></Mesh>
    <Sphere id="1"><Material>2</Material><Center>1</Center>
      <Radius>0.5</Radius></Sphere>
  </Objects>
</Scene>"""


def tex_bwd_scene_xml(out_dir, seed: int = 7) -> str:
    """``TEX_BWD_XML`` with its two images as the JAX test makes them: a
    16x12 and an 8x9 image of uniform random texels, drawn in that order
    from ``np.random.default_rng(seed)``.  Written to ``out_dir``; returns
    the XML's path."""
    from advanced_cpu_raytracing_tpu_torch.scene.images import write_png

    out = _scene_dir(out_dir)
    rng = np.random.default_rng(seed)
    img1, img2 = out / "t1.png", out / "t2.png"
    write_png(str(img1), rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
    write_png(str(img2), rng.integers(0, 256, (9, 8, 3), dtype=np.uint8))
    path = out / "texbwd.xml"
    path.write_text(TEX_BWD_XML.format(img1=img1.resolve(),
                                       img2=img2.resolve()))
    return str(path)


def textured_pt_scene_xml(scenes_dir, out_dir, seed: int = 5) -> str:
    """``scenes_dir/feat_pt.xml`` (left as it is) with UVs on its floor,
    tiled twice, and a bilinear ``replace_kd`` texture on it: a 24x20
    image of uniform random texels from ``np.random.default_rng(seed)``.
    Written to ``out_dir``; returns the XML's path."""
    from advanced_cpu_raytracing_tpu_torch.scene.images import write_png

    out = _scene_dir(out_dir)
    img = out / "floor.png"
    write_png(str(img), np.random.default_rng(seed).integers(
        0, 256, (20, 24, 3), dtype=np.uint8))
    xml = (Path(scenes_dir) / "feat_pt.xml").read_text()
    if "TexCoordData" in xml or "<Textures>" in xml:
        raise ValueError("feat_pt.xml has textures")
    uvs = "0 2   2 2   2 0   0 0" + "   0 0" * 8  # the floor's 4, then 8
    textures = f"""<Textures>
    <Images><Image id="1">{img.resolve()}</Image></Images>
    <TextureMap id="1" type="image">
      <DecalMode>replace_kd</DecalMode><ImageId>1</ImageId>
      <Interpolation>bilinear</Interpolation>
    </TextureMap>
  </Textures>
  """
    xml = xml.replace("<VertexData>", textures + "<VertexData>")
    xml = xml.replace("</VertexData>", "</VertexData>\n  <TexCoordData>"
                      + uvs + "</TexCoordData>")
    xml, n = re.subn(r'(<Mesh id="1"><Material>1</Material>)',
                     r"\1<Textures>1</Textures>", xml)
    if n != 1:
        raise ValueError("feat_pt.xml: no floor mesh 1")
    path = out / "feat_pt_textured.xml"
    path.write_text(xml)
    return str(path)


# ---- the wavefront's main path (slice D1) ----

# the torus standing in feat_pt.xml's box: 48 x 20 cells, 1,920 faces, so
# that with the box's 12 the scene has 1,932 work items, within the 2,048 of
# the wavefront's brute-force strategy (kernel K3); the CPU tests take the
# coarse 96-face one
PT_ENV_TORUS = dict(n_major=48, n_minor=20)
PT_ENV_COARSE_TORUS = dict(n_major=8, n_minor=6)
PT_ENV_TORUS_MATERIAL = """<Material id="5"><AmbientReflectance>0 0 0</AmbientReflectance>
      <DiffuseReflectance>0.6 0.45 0.25</DiffuseReflectance>
      <SpecularReflectance>0 0 0</SpecularReflectance></Material>
  """
PT_ENV_LENS = ("<ApertureSize>0.4</ApertureSize>"
               "<FocusDistance>21</FocusDistance>")


def pt_env_dof_scene_xml(scenes_dir, out_dir, torus=PT_ENV_TORUS,
                         depth: int | None = None) -> str:
    """``scenes_dir/feat_pt.xml`` (left as it is) with a diffuse torus of
    ``torus`` cells (``torus_mesh``, resized to stand in the box: centre
    (0, 3, -1), radii 2.2 and 0.8), the HDR sky ``scenes_dir/textures/
    sky.hdr`` as a SphericalDirectionalLight (it reaches the inside through
    the box's open front) and a thin lens focused on the torus.  Path
    traced with NEE and importance sampling at feat_pt.xml's depth 4, or
    ``depth``: outside the differentiable kernels on two counts (the env
    light, the lens), so ``optimize`` takes the wavefront.  Written with its
    mesh to ``out_dir``; returns the XML's path."""
    scenes_dir = Path(scenes_dir)
    out = _scene_dir(out_dir)
    xml = (scenes_dir / "feat_pt.xml").read_text()
    if "<Textures>" in xml or "ApertureSize" in xml:
        raise ValueError("feat_pt.xml has textures or a lens")
    name = "pt_env_dof_{n_major}x{n_minor}".format(**torus)
    ply = out / f"{name}.ply"
    ply.write_bytes(ply_bytes(*torus_mesh(
        **torus, major=2.2, minor=0.8, center=(0.0, 3.0, -1.0))))
    sky = (scenes_dir / "textures" / "sky.hdr").resolve()
    xml = xml.replace("</NumSamples>", "</NumSamples>" + PT_ENV_LENS)
    xml = xml.replace("<Lights></Lights>", """<Lights>
    <SphericalDirectionalLight id="1"><ImageId>1</ImageId>
    </SphericalDirectionalLight>
  </Lights>
  <Textures><Images><Image id="1">""" + str(sky) + """</Image></Images>
  </Textures>""")
    xml = xml.replace("</Materials>", PT_ENV_TORUS_MATERIAL + "</Materials>")
    xml = xml.replace("</Objects>", f"""  <Mesh id="7"><Material>5</Material>
      <Faces plyFile="{ply.name}"/></Mesh>
  </Objects>""")
    if depth is not None:
        xml = re.sub(r"<MaxRecursionDepth>\d+</MaxRecursionDepth>",
                     f"<MaxRecursionDepth>{depth}</MaxRecursionDepth>", xml)
    if xml.count("SphericalDirectionalLight") != 2 or ply.name not in xml:
        raise ValueError("feat_pt.xml: no empty <Lights> or no </Objects>")
    path = out / (name + ("" if depth is None else f"_d{depth}") + ".xml")
    path.write_text(xml)
    return str(path)
